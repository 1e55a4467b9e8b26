"""Entry points of the port: one kernel call, and a multi-device dry run.

entry(): the per-pair kernel (ops/cuda_dp.align_pairs) on the reference
entry's shapes (``__graft_entry__.entry``): 256 GA pairs of 64 x 64 under
BLOSUM62, gaps 0/-10/-1, the codes drawn from ``default_rng(0)`` as the
reference draws them.

dryrun_multidevice(devices): the whole engine over a list of devices
(engine.resolve_devices), held against the one-device run of its first
entry, on 300 proteins in two buckets, so that cross-bucket tiles,
same-bucket tiles and the diagonal remainder all run on every entry.

    python -m sequencealigner_tpu_torch.entry [DEVICE ...]

runs dryrun_multidevice on the devices given (default: "cuda").
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` scores 256 GA pairs of 64 x 64 through
    the per-pair kernel on ``device`` -> (256,) int32."""
    from . import matrices
    from .engine import from_reference_inputs
    from .ops import cuda_dp

    dev = torch.device(device)
    m = matrices.get("blosum62")
    rng = np.random.default_rng(0)
    B, Lc, Lk = 256, 64, 64
    s1 = rng.integers(0, 20, (B, Lc)).astype(np.int8)
    s2 = rng.integers(0, 20, (B, Lk)).astype(np.int8)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    sub, gaps = from_reference_inputs(m.matrix, (0, -10, -1), dev)
    args = (
        torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev),
        rows, rows,
        torch.full((B,), Lc, dtype=torch.int32, device=dev),
        torch.full((B,), Lk, dtype=torch.int32, device=dev),
        sub, gaps,
    )
    return functools.partial(cuda_dp.align_pairs, algo="ga"), args


def _two_bucket_set():
    """200 proteins of 10-16 and 100 of 50-64 residues from
    ``default_rng(1)``: two buckets; the short rows span two 128-row
    windows."""
    rng = np.random.default_rng(1)
    lens = np.r_[rng.integers(10, 17, 200), rng.integers(50, 65, 100)]
    return [rng.choice(AA, int(n)) for n in lens]


def dryrun_multidevice(devices) -> dict:
    """GA BLOSUM62 10/1 over ``devices`` against the one-device run of its
    first entry: the matrices must be equal and symmetric, and every entry
    must have been sent work.  Returns the multi-device run's pairs and its
    launch groups and cells per entry."""
    from . import matrices
    from .engine import Engine, resolve_devices
    from .io.input import SequenceSet
    from .io.output import OutputStore

    devs = resolve_devices(devices)
    m = matrices.get("blosum62")
    ss = SequenceSet.from_list(_two_bucket_set(), m.lut)
    mats, stats = [], None
    for entries in ([devs[0]], devs):
        store = OutputStore(ss.num, triangular=False, spill=False)
        eng = Engine("ga", m.matrix, (0, -10, -1), device=entries)
        stats = eng.align_all(ss, store, progress=False)
        if stats.pairs != ss.num * (ss.num - 1) // 2:
            raise AssertionError(f"{entries}: {stats.pairs} pairs")
        mats.append(np.asarray(store.matrix).reshape(ss.num, ss.num))
    one, many = mats
    if not np.array_equal(one, many) or not np.array_equal(many, many.T):
        raise AssertionError(f"{devices}: matrix differs from one device's "
                             "or is not symmetric")
    if min(stats.lane_launches) == 0:
        raise AssertionError(f"{devices}: an entry got no launch "
                             f"({stats.lane_launches})")
    return {"pairs": stats.pairs, "launches": stats.lane_launches,
            "cells": stats.lane_cells}


if __name__ == "__main__":
    devices = sys.argv[1:] or "cuda"
    print(f"dryrun_multidevice({devices}): {dryrun_multidevice(devices)}")
