"""Multi-host distribution of the pair space over ``torch.distributed``.

Port of ``sequencealigner_tpu/parallel/multihost.py``: every host parses
the same input and walks the same block stream, scores the blocks the
engine's least-loaded striping gives it (``Engine.align_all(partition=)``)
on its local devices, and at every flush point exchanges its (i, j, score)
triplets with all other hosts (``TripletMerger``), so every host ends with
the complete result.  No sequence data moves; only scores (20 B a pair,
``pack_triplets``) cross the network.

The collectives run over gloo on CPU tensors: the payloads are host
arrays, and gloo needs no device.  Merge points must be globally
deterministic, which the engine guarantees by counting every block, owned
or not, towards its flush points.

Environment contract (the reference's): ``SEQALIGN_TPU_COORDINATOR=
host:port``, ``SEQALIGN_TPU_NUM_PROCESSES=N`` and
``SEQALIGN_TPU_PROCESS_ID=K``; or ``SEQALIGN_TPU_DISTRIBUTED=1`` with the
standard ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` of
a launcher (``env://``).  Without either, a run is one host.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

#: Seconds a host waits for its peers, at start-up and in every collective
#: (gloo raises past it, and the run exits non-zero).
TIMEOUT = 600.0


def init_from_env(timeout: float = TIMEOUT) -> tuple[int, int]:
    """Join the process group when the environment asks for it; returns
    (process index, process count), (0, 1) for a single host."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get("SEQALIGN_TPU_COORDINATOR")
    wait = datetime.timedelta(seconds=timeout)
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["SEQALIGN_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["SEQALIGN_TPU_PROCESS_ID"]), timeout=wait,
        )
    elif os.environ.get("SEQALIGN_TPU_DISTRIBUTED") == "1":
        dist.init_process_group("gloo", init_method="env://", timeout=wait)
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def default_gather():
    """The real collective: an all-gather of one host-local NumPy array
    (every host's of the same shape and dtype) -> (nhosts, ...) array."""

    def gather(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x))
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.stack(parts).numpy()

    return gather


#: Quantum (int32 words, 4 MiB) the packed payload is padded to, as the
#: reference pads it (there the collective compiles per shape); here it
#: also bounds the payload sizes gloo sees to few distinct ones.
PAD_QUANTUM = 1 << 20


def pack_triplets(i, j, s, cap: int) -> np.ndarray:
    """One host's (i, j, score) triplets as a single padded int32 payload:
    [i as little-endian int64 word pairs | j likewise | s], zero-padded to
    ``cap`` words.  5 words (20 B) per pair, one collective per flush."""
    n = len(s)
    buf = np.zeros(cap, np.int32)
    buf[: 2 * n] = np.ascontiguousarray(np.asarray(i, np.int64)).view(np.int32)
    buf[2 * n : 4 * n] = np.ascontiguousarray(
        np.asarray(j, np.int64)
    ).view(np.int32)
    buf[4 * n : 5 * n] = np.asarray(s, np.int32)
    return buf


class TripletMerger:
    """Exchange (i, j, score) triplets between hosts; every host returns the
    union, so each host's OutputStore converges to the full matrix.

    ``gather`` maps a host-local ndarray to a stacked (nhosts, ...) ndarray
    (injected in tests; defaults to ``default_gather``).  Two collectives
    per merge: a fixed-shape word-count exchange, then ONE packed payload
    gather (pack_triplets), skipped when every host is empty.  ``seconds``
    and ``bytes`` add up the time in the exchange and this host's bytes
    of both gathers."""

    def __init__(self, nhosts: int, gather=None):
        self.nhosts = nhosts
        self._gather = gather
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0

    def __call__(
        self, i: np.ndarray, j: np.ndarray, s: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.nhosts == 1:
            return i, j, s
        t0 = time.perf_counter()
        self.calls += 1
        try:
            return self._merge(i, j, s)
        finally:
            self.seconds += time.perf_counter() - t0

    def _merge(self, i, j, s):
        gather = self._gather or default_gather()
        words = np.asarray([5 * len(s)], dtype=np.int64)
        sizes = np.asarray(gather(words)).reshape(-1)
        self.bytes += words.nbytes
        m = int(sizes.max())
        if m == 0:
            # Every host is empty at this flush point (the engine flushes on
            # a global cadence whether or not this host owned blocks since
            # the last one): the word-count exchange kept the hosts aligned.
            return i, j, s
        cap = max(PAD_QUANTUM, -(-m // PAD_QUANTUM) * PAD_QUANTUM)
        payload = pack_triplets(i, j, s, cap)
        g = np.asarray(gather(payload))  # (nhosts, cap)
        self.bytes += payload.nbytes
        ii, jj, ss = [], [], []
        for h in range(len(sizes)):
            nh = int(sizes[h]) // 5
            row = g[h]
            ii.append(np.ascontiguousarray(row[: 2 * nh]).view(np.int64))
            jj.append(np.ascontiguousarray(row[2 * nh : 4 * nh]).view(np.int64))
            ss.append(row[4 * nh : 5 * nh])
        return np.concatenate(ii), np.concatenate(jj), np.concatenate(ss)


def barrier(name: str = "seqalign") -> None:
    """Cross-host sync point (e.g. before host 0 writes the output file);
    ``name`` labels it for the reader, as the reference's does."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
