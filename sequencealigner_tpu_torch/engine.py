"""Alignment engine of the port: the tiles-v2 schedule on one device.

Port of ``sequencealigner_tpu/engine.py`` (its default single-device path).
Per bucket combo the pair space is scored as outer-product tiles
(ops/cuda_dp.align_tiles); a same-bucket combo also sends the per-window
diagonal triangles through the per-pair kernel (ops/cuda_dp.align_pairs),
whose pair rows are inverted from slot ids on the device.  Scores are
narrowed to int16 on the device where they provably fit, copied to pinned
host memory on the dispatch stream, and scattered into the OutputStore by a
background flusher thread while later dispatches run; a poller reads
completion through ``torch.cuda.Event.query()`` for live progress.

On ``device="cpu"`` the same schedule runs through the kernels' plain
PyTorch versions (the -C path, and what the CPU tests drive).

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the linear-v1 schedule (SEQALIGN_TPU_OUTER=0, A8), bucket edges beyond
W_MAX and matrices with |score| > 127 (A9), checkpoint journals (A11) and
multi-host partitions and mergers (A13).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib

import numpy as np
import torch

from . import ui
from .io.input import SequenceSet
from .io.output import OutputStore
from .ops import cuda_dp, geometry
from .ops.geometry import BIG_NEG, PAD
from .scheduler import TILE_B, TILE_S, TRI_W, Schedule

ALGOS = ("nw", "ga", "sw")

#: Pairs in flight before a flush (bounds host memory for block metadata).
FLUSH_PAIRS = int(os.environ.get("SEQALIGN_TPU_FLUSH_PAIRS", 1 << 22))

assert TILE_S == geometry.S_TILE and TILE_B == geometry.LANE


def from_reference_inputs(sub, gaps, device):
    """The reference Engine's (24, 24) int32 matrix and negated gap triple
    as the port's device tensors: the (25, 25) padded matrix (PAD row and
    column BIG_NEG, as xla_dp.padded_submatrix) and the (3,) int32 gaps."""
    sub_p = np.full((PAD + 1, PAD + 1), BIG_NEG, np.int32)
    sub_p[:24, :24] = np.asarray(sub, np.int32)
    return (
        torch.from_numpy(sub_p).to(device),
        torch.from_numpy(np.asarray(gaps, np.int32).copy()).to(device),
    )


def _tri_invert(lin):
    """Closed-form triangle inversion lin -> (j, i), i < j: float32 sqrt and
    two integer corrections (exact far beyond the TRI_W-slot windows)."""
    j = ((1.0 + torch.sqrt(1.0 + 8.0 * lin.to(torch.float32))) * 0.5).to(
        torch.int64
    )
    for _ in range(2):
        j = torch.where(j * (j - 1) // 2 > lin, j - 1, j)
        j = torch.where((j + 1) * j // 2 <= lin, j + 1, j)
    return j, lin - j * (j - 1) // 2


def _diag_rows(lin, n_slots: int, rows: int):
    """Bucket rows (rc, rk) of diagonal-remainder slot ids (scheduler
    DiagBlock): window u = lin // TRI_W, local triangle id inverted; pad
    slots map to slot 0 and tail-window rows clamp to the bucket."""
    lin = torch.where(lin < n_slots, lin, 0)
    u = lin // TRI_W
    j, i = _tri_invert(lin - u * TRI_W)
    rc = torch.clamp_max(u * TILE_B + j, rows - 1).to(torch.int32)
    rk = torch.clamp_max(u * TILE_B + i, rows - 1).to(torch.int32)
    return rc, rk


@dataclasses.dataclass
class AlignStats:
    pairs: int = 0
    cells: int = 0
    seconds: float = 0.0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0


class Engine:
    def __init__(self, algo: str, sub: np.ndarray, gaps, *, device="cuda"):
        if algo not in ALGOS:
            raise ValueError(f"unknown algorithm {algo!r}")
        if np.abs(np.asarray(sub, np.int64)).max() > 127:
            raise NotImplementedError(
                "substitution scores beyond the int8 range are not ported "
                "yet (ROADMAP A9)"
            )
        if os.environ.get("SEQALIGN_TPU_OUTER", "1") == "0":
            raise NotImplementedError(
                "the linear-v1 schedule (SEQALIGN_TPU_OUTER=0) is not ported "
                "yet (ROADMAP A8)"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available")
        self.algo = algo
        self.gaps = np.asarray(gaps, dtype=np.int32)
        self.sub_dev, self.gaps_dev = from_reference_inputs(
            sub, self.gaps, self.device
        )
        self._cuda = self.device.type == "cuda"
        self._plock = threading.Lock()  # guards the pending list (poller)
        # One-entry cache of per-bucket device arrays, keyed by SequenceSet
        # identity: repeated align_all calls on one set skip the uploads.
        self._bucket_cache: tuple | None = None

    def schedule_token(self, lengths) -> str:
        """Identifier of the block-schedule geometry for ``lengths``; equal
        to the reference engine's token on its default (tile) path."""
        sched = Schedule.build(np.asarray(lengths))
        geo = zlib.crc32(np.asarray(
            [(b.edge, b.start, b.end) for b in sched.buckets], np.int64
        ).tobytes())
        if all(geometry.supports(b.edge, b.edge) for b in sched.buckets):
            return f"tiles-v2.{geo:08x}"
        return f"linear-v1.{geo:08x}"

    def _put(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self._cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _bucket_arrays(self, ss: SequenceSet, sched: Schedule) -> list:
        """Per bucket: (cwords, kmatT, klens, diag) on the device,
        the tile kernel's arrays (geometry.pack_bucket_outer) plus, for
        buckets with a diagonal remainder, the per-pair kernel's (count,
        edge) int8 code matrix and int32 lengths."""
        from .io import native

        lut = ss.lut
        out = []
        for b in sched.buckets:
            if not geometry.supports(b.edge, b.edge):
                raise NotImplementedError(
                    f"bucket edge {b.edge} exceeds W_MAX={geometry.W_MAX}; "
                    "long sequences are not ported yet (ROADMAP A9)"
                )
            rows = sched.order[b.start : b.end]
            mat = native.pack_rows(ss.data, ss.offsets, rows, b.edge, lut, PAD)
            if mat is None:
                mat = np.full((b.count, b.edge), PAD, dtype=np.int8)
                for local, orig in enumerate(rows):
                    s = ss.data[ss.offsets[orig] : ss.offsets[orig + 1]]
                    mat[local, : len(s)] = lut[s]
            blens = sched.lengths_sorted[b.start : b.end].astype(np.int32)
            cw, kT, kl = geometry.pack_bucket_outer(mat, blens, b.edge)
            diag = None
            if b.count >= 2:
                diag = (self._put(mat), self._put(blens))
            out.append((self._put(cw), self._put(kT), self._put(kl), diag))
        return out

    def _diag_width(self, Lc: int, n_slots: int) -> int:
        """Slots per diagonal-remainder block: the reference's per-pair
        superblock width (pow2 stripes of pick_S, shrunk for small combos),
        capped near 2^26 cells so one block does not dwarf the tiles."""
        B = geometry.LANE
        nb, Kpad, CD, W = geometry.geometry(Lc, Lc, B)
        S = geometry.pick_S(B, Kpad, W)
        s_needed = 1 << (max(1, -(-n_slots // B)) - 1).bit_length()
        width = max(1, min(S, s_needed)) * B
        return min(width, max(B, (1 << 26) // (Lc * Lc) // B * B))

    def _int16_ok(self, Lc: int, Lk: int) -> bool:
        """Whether every score of an (Lc, Lk)-bucket pair provably fits
        int16: any alignment path has at most Lc + Lk steps, each changing
        the score by at most max(|sub| <= 127, |gap|, |open|, |extend|)."""
        step = max(127, *(abs(int(g)) for g in self.gaps))
        return (Lc + Lk) * step < 32767

    def _enqueue(self, dev: torch.Tensor, part: list, pending: list) -> None:
        """Narrowed scores -> host.  On CUDA the copy goes to pinned memory
        on the dispatch stream and an event marks its completion, so the
        flusher waits only for this dispatch."""
        flat = dev.reshape(-1)
        event = None
        if self._cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = flat
        with self._plock:
            pending.append([host, event, part, False])

    def _dispatch_tiles(self, blks: list, ctx: tuple, pending: list) -> None:
        """One tile-kernel launch for a group of tiles: the only upload is
        the (T, 2) int32 descriptor array."""
        cw, km, kl, Lc, Lk = ctx
        desc = np.asarray([blk.desc for blk in blks], np.int32)
        out = cuda_dp.align_tiles(
            self._put(desc), cw, km, kl, self.sub_dev, self.gaps_dev,
            algo=self.algo,
        )
        if self._int16_ok(Lc, Lk):
            out = out.to(torch.int16)
        self._enqueue(out, blks, pending)

    def _dispatch_diag(self, blks: list, ctx: tuple, pending: list) -> None:
        """One per-pair launch for equal-width diagonal-remainder blocks:
        one int64 start id per block goes up, slot ids are inverted to
        bucket rows on the device."""
        (mat, lens), n_slots, Lc = ctx
        width = blks[0].width
        starts = self._put(np.asarray([b.start for b in blks], np.int64))
        lin = (starts[:, None] + torch.arange(width, device=self.device)
               ).reshape(-1)
        rc, rk = _diag_rows(lin, n_slots, mat.shape[0])
        out = cuda_dp.align_pairs(
            mat, mat, rc, rk, lens, lens, self.sub_dev, self.gaps_dev,
            algo=self.algo,
        )
        if self._int16_ok(Lc, Lc):
            out = out.to(torch.int16)
        self._enqueue(out, blks, pending)

    def align_all(
        self,
        ss: SequenceSet,
        store: OutputStore | None,
        *,
        progress: bool = True,
        partition=None,
        merger=None,
        journal=None,
    ) -> AlignStats:
        """Score the whole pair space into ``store`` (None, as with the
        CLI's -W: scores are fetched and counted but not kept)."""
        if journal is not None:
            raise NotImplementedError(
                "checkpoint journals are not ported yet (ROADMAP A11)"
            )
        if partition is not None or merger is not None:
            raise NotImplementedError(
                "multi-host partitions are not ported yet (ROADMAP A13)"
            )
        sched = Schedule.build(ss.lengths)
        total_pairs = sched.total_pairs()
        ui.pinfo("Performing %d pairwise alignments", total_pairs)
        bar = ui.Progress(total_pairs, "Aligning sequences") if progress else None

        t0 = time.perf_counter()
        if self._bucket_cache is not None and self._bucket_cache[0] is ss:
            buckets = self._bucket_cache[1]
        else:
            buckets = self._bucket_arrays(ss, sched)
            self._bucket_cache = (ss, buckets)

        stats = AlignStats()
        pending: list = []  # [host scores, event, blocks, progress claimed]
        inflight = 0
        flusher: list = []  # at most one outstanding async flush
        flush_exc: list = []

        def do_flush(batch):
            """Fetch a claimed batch of dispatches and scatter its scores
            into the store (on the flusher thread, overlapping later
            dispatches)."""
            with self._plock:
                claimed = {id(e): not e[3] for e in batch}
                for e in batch:
                    e[3] = True
            ii, jj, sc = [], [], []
            for entry in batch:
                host, event, blks, _ = entry
                if event is not None:
                    event.synchronize()
                buf = host.numpy()
                off = 0
                for blk in blks:
                    scores = buf[off : off + blk.width]
                    off += blk.width
                    if store is None:
                        cells = blk.cells
                    else:
                        oi, oj, cells = blk.pairs()
                        ii.append(oi)
                        jj.append(oj)
                        sc.append(blk.select_valid(scores).astype(np.int32))
                    stats.pairs += blk.n_valid
                    stats.cells += cells
                    if bar and claimed[id(entry)]:
                        bar.add(blk.n_valid)
            if sc:
                store.fill_pairs(
                    np.concatenate(ii), np.concatenate(jj), np.concatenate(sc)
                )

        def join_flusher():
            if flusher:
                flusher.pop().join()
            if flush_exc:
                raise flush_exc.pop()

        def run_flush(batch):
            try:
                do_flush(batch)
            except BaseException as e:  # re-raised on the main thread at join
                flush_exc.append(e)

        def flush(sync: bool = False):
            nonlocal inflight
            join_flusher()
            with self._plock:
                batch = list(pending)
                pending.clear()
            inflight = 0
            if not batch:
                return
            if sync:
                do_flush(batch)
            else:
                t = threading.Thread(target=run_flush, args=(batch,), daemon=True)
                flusher.append(t)
                t.start()

        def poll_progress(stop):
            # Live progress between flushes: Event.query() is a non-blocking
            # completion probe of the oldest unclaimed dispatch (completion
            # is in order on one stream).
            while not stop.wait(0.25):
                with self._plock:
                    e = next((x for x in pending if not x[3]), None)
                if e is None or (e[1] is not None and not e[1].query()):
                    continue
                with self._plock:
                    if e[3]:
                        continue
                    e[3] = True
                bar.add(sum(blk.n_valid for blk in e[2]))

        poll_stop = threading.Event()
        poller = None
        if bar:
            poller = threading.Thread(
                target=poll_progress, args=(poll_stop,), daemon=True
            )
            poller.start()

        def pace(dispatch) -> None:
            """Flush at FLUSH_PAIRS; otherwise, when the flusher is idle and
            dispatches are in flight, start fetching them now (eager
            overlap: only the last dispatch's copy lands after the loop)."""
            if inflight >= FLUSH_PAIRS:
                dispatch()
                flush()
            elif pending and (not flusher or not flusher[0].is_alive()):
                flush()

        for a, b in sched.combos():
            if sched.combo_pair_count(a, b) == 0:
                continue
            Lk = sched.buckets[a].edge
            Lc = sched.buckets[b].edge
            tile_ctx = (buckets[b][0], buckets[a][1], buckets[a][2], Lc, Lk)
            T_group = geometry.pick_T(Lc, Lk)
            blks: list = []

            def dispatch_tiles():
                nonlocal blks
                if blks:
                    self._dispatch_tiles(blks, tile_ctx, pending)
                    blks = []

            for blk in sched.tiles(a, b):
                inflight += blk.width
                blks.append(blk)
                if len(blks) >= T_group:
                    dispatch_tiles()
                pace(dispatch_tiles)
            dispatch_tiles()
            diag = buckets[a][3]
            if a != b or diag is None:
                continue
            # Diagonal remainder: the per-window triangles excluded from
            # the tile stream (Schedule.tiles), through the per-pair kernel.
            n_slots = -(-sched.buckets[a].count // TILE_B) * TRI_W
            diag_ctx = (diag, n_slots, Lc)
            dblks: list = []

            def dispatch_diag():
                nonlocal dblks
                if dblks:
                    self._dispatch_diag(dblks, diag_ctx, pending)
                    dblks = []

            for blk in sched.diag_blocks(
                a, self._diag_width(Lc, n_slots), tail_min=TILE_B
            ):
                if dblks and blk.width != dblks[0].width:
                    dispatch_diag()
                inflight += blk.width
                dblks.append(blk)
                pace(dispatch_diag)
            dispatch_diag()
        if poller is not None:
            poll_stop.set()
            poller.join(timeout=2.0)
        flush(sync=True)
        join_flusher()
        if bar:
            bar.end()
        stats.seconds = time.perf_counter() - t0
        return stats
