"""Alignment engine of the port: the reference's two schedules over a list
of devices, and its multi-host striping.

Port of ``sequencealigner_tpu/engine.py``.

- **tiles-v2** (the default): per bucket combo the pair space is scored as
  outer-product tiles (ops/cuda_dp.align_tiles); a same-bucket combo also
  sends the per-window diagonal triangles through the per-pair kernel
  (ops/cuda_dp.align_pairs).
- **linear-v1**: every combo is cut into superblocks of consecutive pair
  ids (rect: id = rc * count_k + rk; tri: the closed-form triangle) and
  scored by the per-pair kernel.  A run takes it, as the reference does,
  when SEQALIGN_TPU_OUTER=0 at construction, when any bucket is wider than
  geometry.W_MAX (long sequences) or when the matrix has |score| > 127.
  The kernels need neither bound (the band-crossing row lives in device
  memory, the matrix is int32); the block stream follows the reference's
  so that schedule tokens and block ids mean the same pairs in both.

Devices (the reference's ``make_mesh``): ``device="cuda"`` is every local
CUDA device, ``"cuda:K"`` or ``"cpu"`` one device, and a list of such
devices one entry each, repeats included.  Every entry holds its own copy
of the bucket arrays, substitution matrix and gaps and, on a CUDA device,
its own stream, on which its uploads, launches, narrowing and score copies
all run (the caching allocator hands a stream's memory only to later work
on that stream).  The main thread walks the schedule and sends each launch
group to the entry with the fewest cells sent so far, ties to the lowest
index; launches are asynchronous, so one thread feeds every stream.  No
collective runs: scores come home through the flusher.  The reference
splits each dispatch over its mesh instead, so its block widths scale with
its device count (ROADMAP C5); here the block stream (widths, tails, ids)
and the schedule token are those of the one-device reference whatever the
device count, so a journal written on one device resumes on three and the
other way round.

Pair rows are inverted from one start id per block on the device.  Scores
are narrowed to int16 on the device where they provably fit, copied to
pinned host memory on the entry's stream, and handed to the flusher
(flusher.py), which scatters them into the OutputStore on a background
thread while later dispatches run; a poller reads completion through
``torch.cuda.Event.query()`` for live progress.

On ``device="cpu"`` the same schedules run through the kernels' plain
PyTorch versions (the -C path, and what the CPU tests drive).

Checkpoint journals (checkpoint.Journal) record the global index of every
block the schedule yields, in schedule order, as the reference numbers
them; launch grouping changes no index, so a journal of either package
resumes in the other under the same schedule token.

Multi-host (``partition=(host, nhosts)``, ``merger=``): every host walks
the whole block stream and owns the blocks that the reference's
least-loaded striping gives it; flush points depend on the global block
stream only, so every host reaches each merge together.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time
import zlib

import numpy as np
import torch

from . import trace, ui
from .flusher import Flusher
from .io.input import SequenceSet
from .io.output import OutputStore
from .ops import cuda_dp, geometry
from .ops.geometry import BIG_NEG, PAD
from .scheduler import TILE_B, TILE_S, TRI_W, Block, DiagBlock, Schedule

ALGOS = ("nw", "ga", "sw")

#: Pairs in flight before a flush (bounds host memory for block metadata).
FLUSH_PAIRS = int(os.environ.get("SEQALIGN_TPU_FLUSH_PAIRS", 1 << 22))

#: Seconds between checkpoint sync points (journal runs only): each one
#: msyncs the persistent store, then commits the block ids flushed since the
#: last.  Syncing every flush rewrites nearly the whole store file at flush
#: cadence (one flush's scatter dirties most of its pages); the interval
#: bounds the machine-crash window instead.  0 syncs at every flush.
SYNC_INTERVAL = float(os.environ.get("SEQALIGN_TPU_SYNC_INTERVAL", 300.0))

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
    two integer corrections, as the reference computes it (exact for row
    counts up to ~16M; Schedule.build splits buckets at 2^24 rows)."""
    j = ((1.0 + torch.sqrt(1.0 + 8.0 * lin.to(torch.float32))) * 0.5).to(
        torch.int64
    )
    for _ in range(2):
        j = torch.where(j * (j - 1) // 2 > lin, j - 1, j)
        j = torch.where((j + 1) * j // 2 <= lin, j + 1, j)
    return j, lin - j * (j - 1) // 2


def _pair_rows(lin, npairs: int, rows: int, tri: bool):
    """Bucket rows (rc, rk) of linear-v1 pair ids: a same-bucket combo's
    triangle (id = rc*(rc-1)/2 + rk) or a cross-bucket rectangle (id =
    rc * rows + rk, rows the k bucket's count); pad ids map to pair 0."""
    lin = torch.where(lin < npairs, lin, 0)
    if tri:
        rc, rk = _tri_invert(lin)
    else:
        rc, rk = lin // rows, lin % rows
    return rc.to(torch.int32), rk.to(torch.int32)


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


class _BlockCells:
    """True DP cells of a schedule's blocks without their per-pair arrays.
    The main thread needs them to send launch groups to entries and
    blocks to hosts, and to count a traced run's launches; ``Block.cells``
    builds the arrays with numpy, which also takes the flusher's fused C
    pass (``Block.pairs``) away, and ``DiagBlock.cells`` builds them for
    slots the flusher's direct scatter never needs as arrays.  Tile blocks
    count analytically already."""

    def __init__(self, sched: Schedule):
        self.psums = sched.length_psums()
        self.qsums: dict = {}
        self.wsums: dict = {}

    def _q(self, b: int) -> np.ndarray:
        """q[r] = sum over rows t < r of len(t) * psum(t), for bucket b."""
        if b not in self.qsums:
            p = self.psums[b]
            self.qsums[b] = np.concatenate(
                ([0], np.cumsum(np.diff(p) * p[:-1], dtype=np.int64)))
        return self.qsums[b]

    def _diag_upto(self, b: int, t: int) -> int:
        """Cells of bucket b's diagonal-remainder slots [0, t): window
        u = t // TRI_W pairs rows u*TILE_B + j and u*TILE_B + i, i < j, at
        slot j(j-1)/2 + i, over the rows the bucket has there."""
        p, q = self.psums[b], self._q(b)
        rows = len(p) - 1
        if b not in self.wsums:
            # wsums[b][u]: the cells of windows before u, each whole.
            lo = np.arange(0, rows, TILE_B)
            hi = np.minimum(lo + TILE_B, rows)
            self.wsums[b] = np.concatenate(([0], np.cumsum(
                q[hi] - q[lo] - p[lo] * (p[hi] - p[lo]))))
        w = self.wsums[b]
        u, loc = divmod(t, TRI_W)
        base = u * TILE_B
        if base >= rows:
            return int(w[-1])
        j, i = _tri_row(loc)
        if j >= rows - base:  # past the bucket's last row: the whole window
            j, i = rows - base, 0
        out = w[u] + q[base + j] - q[base] - p[base] * (p[base + j] - p[base])
        if i:
            out += (p[base + j + 1] - p[base + j]) * (p[base + i] - p[base])
        return int(out)

    def __call__(self, blk) -> int:
        if isinstance(blk, DiagBlock):
            return (self._diag_upto(blk.bucket, blk.start + blk.width)
                    - self._diag_upto(blk.bucket, blk.start))
        if not isinstance(blk, Block):
            return blk.cells
        pk, pc = self.psums[blk.bucket_k], self.psums[blk.bucket_c]
        s, e = blk.start, blk.start + blk.n_valid
        if blk.bucket_k != blk.bucket_c:
            # Rectangle: id = rc * rows + rk.
            rows = len(pk) - 1
            (r0, k0), (r1, k1) = divmod(s, rows), divmod(e, rows)
            if r0 == r1:
                return int((pc[r0 + 1] - pc[r0]) * (pk[k1] - pk[k0]))
            out = ((pc[r0 + 1] - pc[r0]) * (pk[rows] - pk[k0])
                   + (pc[r1] - pc[r0 + 1]) * pk[rows])
            if k1:
                out += (pc[r1 + 1] - pc[r1]) * pk[k1]
            return int(out)
        # Triangle: row j holds ids j(j-1)/2 + i, i < j.
        (j0, i0), (j1, i1) = (_tri_row(x) for x in (s, e))
        if j0 == j1:
            return int((pk[j0 + 1] - pk[j0]) * (pk[i1] - pk[i0]))
        q = self._q(blk.bucket_k)
        out = (pk[j0 + 1] - pk[j0]) * (pk[j0] - pk[i0]) + q[j1] - q[j0 + 1]
        if i1:
            out += (pk[j1 + 1] - pk[j1]) * pk[i1]
        return int(out)


def _tri_row(lin: int) -> tuple[int, int]:
    """(j, i) of triangle id ``lin`` = j(j-1)/2 + i, i < j, exactly."""
    j = (1 + math.isqrt(1 + 8 * lin)) // 2
    return j, lin - j * (j - 1) // 2


def resolve_devices(device) -> list:
    """The engine's entries for ``device``: ``"cuda"`` (a CUDA device
    without an index) is every local CUDA device, as the reference's
    ``make_mesh("auto")``; ``"cuda:K"`` or ``"cpu"`` is that one device; a
    list or tuple of such devices is their entries in order, repeats
    included.  All entries are CUDA devices, or all are the CPU.  Raises
    when a CUDA device is asked for and there is none: nothing falls back
    to the CPU."""
    items = list(device) if isinstance(device, (list, tuple)) else [device]
    out = []
    for item in items:
        d = torch.device(item)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available")
            n = torch.cuda.device_count()
            if d.index is None:
                out.extend(torch.device("cuda", k) for k in range(n))
                continue
            if d.index >= n:
                raise ValueError(f"{d}: this host has {n} CUDA devices")
        elif d.type != "cpu":
            raise ValueError(f"the engine runs on CUDA devices or the CPU, "
                             f"not {d}")
        out.append(d)
    if not out or len({d.type for d in out}) > 1:
        raise ValueError(f"device {device!r}: one or more entries, all CUDA "
                         "devices or all the CPU")
    return out


@dataclasses.dataclass
class _Lane:
    """One entry of the engine's device list: its device, its own stream on
    a CUDA device (None on the CPU) and its copy of the substitution matrix
    and gaps."""

    device: torch.device
    stream: object
    sub: torch.Tensor | None = None
    gaps: torch.Tensor | None = None

    @contextlib.contextmanager
    def on(self):
        """The entry's device and stream, current for its uploads, launches
        and score copies."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


@dataclasses.dataclass
class AlignStats:
    pairs: int = 0
    cells: int = 0
    seconds: float = 0.0
    pairs_resumed: int = 0  # skipped: their blocks were journaled
    # Per entry of the engine's device list: launch groups and cells sent.
    lane_launches: list = dataclasses.field(default_factory=list)
    lane_cells: list = dataclasses.field(default_factory=list)

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0


class Engine:
    def __init__(self, algo: str, sub: np.ndarray, gaps, *, device="cuda",
                 target_cells: int | None = None):
        """device: see resolve_devices.  target_cells: DP cells per block
        of the combos the kernels' tile geometry does not take (long edges,
        or |score| > 127), as the reference's; default 2^24."""
        if algo not in ALGOS:
            raise ValueError(f"unknown algorithm {algo!r}")
        self.devices = resolve_devices(device)
        self._cuda = self.devices[0].type == "cuda"
        self.algo = algo
        self.gaps = np.asarray(gaps, dtype=np.int32)
        self.target_cells = target_cells
        self.lanes = []
        for d in self.devices:
            lane = _Lane(d, torch.cuda.Stream(d) if self._cuda else None)
            with lane.on():
                lane.sub, lane.gaps = from_reference_inputs(sub, self.gaps, d)
            self.lanes.append(lane)
        # The largest |substitution score| bounds the int16 narrowing.  Past
        # the int8 range the reference leaves its Pallas kernels (their
        # score grid is int8), so such a run takes linear-v1 with the
        # target-cells block widths there, and here too (same block ids).
        self.max_sub = int(np.abs(np.asarray(sub, np.int64)).max())
        # Read at construction, as the reference does: 0 selects linear-v1.
        self.outer = os.environ.get("SEQALIGN_TPU_OUTER", "1") != "0"
        # One-entry cache of the entries' bucket arrays, keyed by
        # SequenceSet identity: repeated align_all calls on one set skip
        # the uploads.
        self._bucket_cache: tuple | None = None
        # Launch groups and cells sent to each entry in the current run,
        # the run's block cells, and the trace.Run that records it.
        self._lane_launches = [0] * len(self.lanes)
        self._lane_cells = [0] * len(self.lanes)
        self._cells = None
        self._rec = None

    def _tiles(self, sched: Schedule) -> bool:
        """Whether a run over ``sched`` takes tiles-v2 (else linear-v1)."""
        return self.outer and self.max_sub <= 127 and all(
            geometry.supports(b.edge, b.edge) for b in sched.buckets
        )

    def schedule_token(self, lengths) -> str:
        """Identifier of the block-schedule geometry for ``lengths``; equal
        to the reference engine's token (its Pallas engine) in every
        configuration: tiles-v2 or linear-v1, and a hash of the buckets.
        It holds no device count: the block stream does not depend on
        it."""
        sched = Schedule.build(np.asarray(lengths))
        geo = zlib.crc32(np.asarray(
            [(b.edge, b.start, b.end) for b in sched.buckets], np.int64
        ).tobytes())
        kind = "tiles-v2" if self._tiles(sched) else "linear-v1"
        return f"{kind}.{geo:08x}"

    @staticmethod
    def _put(x: np.ndarray, lane: _Lane) -> torch.Tensor:
        """``x`` on the entry's device; on a CUDA device the copy runs on
        the current stream, which callers make the entry's."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if lane.stream is None:
            return t
        return t.pin_memory().to(lane.device, non_blocking=True)

    def _bucket_arrays(self, ss: SequenceSet, sched: Schedule,
                       tiles: bool) -> list:
        """Per entry, per bucket: ``(codes, outer)`` on its device.
        ``codes`` is the per-pair kernel's (count, edge) int8 code matrix
        and int32 lengths; ``outer`` the tile kernel's (cwords, kmatT,
        klens) (geometry.pack_bucket_outer), None under linear-v1."""
        from .io import native

        lut = ss.lut
        host = []
        for b in sched.buckets:
            rows = sched.order[b.start : b.end]
            mat = native.pack_rows(ss.data, ss.offsets, rows, b.edge, lut, PAD)
            if mat is None:
                mat = np.full((b.count, b.edge), PAD, dtype=np.int8)
                for local, orig in enumerate(rows):
                    s = ss.data[ss.offsets[orig] : ss.offsets[orig + 1]]
                    mat[local, : len(s)] = lut[s]
            blens = sched.lengths_sorted[b.start : b.end].astype(np.int32)
            outer = (geometry.pack_bucket_outer(mat, blens, b.edge)
                     if tiles else None)
            host.append(((mat, blens), outer))
        out = []
        for lane in self.lanes:
            with lane.on():
                out.append([
                    (tuple(self._put(a, lane) for a in codes),
                     None if outer is None
                     else tuple(self._put(a, lane) for a in outer))
                    for codes, outer in host
                ])
        return out

    def _superblock_width(self, Lc: int, Lk: int, npairs: int):
        """(pairs per block, tail unit) of a per-pair combo, as the
        reference's one-device engine sizes them (its _superblock_width):
        within the kernel's geometry, power-of-two stripes of LANE pairs up
        to pick_S (tail unit LANE); beyond it (long edges, or |score| > 127),
        about target_cells (2^24) cells per block with no tail shrinking
        (unit 0)."""
        if self.max_sub <= 127 and geometry.supports(Lc, Lk):
            B = geometry.LANE
            nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
            S = geometry.pick_S(B, Kpad, W)
            s_needed = 1 << (max(1, -(-npairs // B)) - 1).bit_length()
            return max(1, min(S, s_needed)) * B, B
        target = self.target_cells or (1 << 24)
        b = max(8, min(4096, target // (Lc * Lk)))
        b = 1 << (int(b).bit_length() - 1)
        while b // 2 >= 8 and b // 2 >= npairs:
            b //= 2
        return b, 0

    def _diag_width(self, Lc: int, n_slots: int) -> int:
        """Slots per diagonal-remainder block: the per-pair superblock width,
        capped near 2^26 cells so one block does not dwarf the tiles."""
        width, B = self._superblock_width(Lc, Lc, n_slots)
        return min(width, max(B, (1 << 26) // (Lc * Lc) // B * B))

    def _int16_ok(self, Lc: int, Lk: int) -> bool:
        """Whether every score of an (Lc, Lk)-bucket pair provably fits
        int16: any alignment path has at most Lc + Lk steps, each changing
        the score by at most max(127, max|sub|, |gap|, |open|, |extend|)."""
        step = max(127, self.max_sub, *(abs(int(g)) for g in self.gaps))
        return (Lc + Lk) * step < 32767

    def _dp16_ok(self, Lc: int, Lk: int) -> bool:
        """Whether the tile kernel's 16-bit form (cuda_dp.align_tiles'
        ``dp16``) computes every value of an (Lc, Lk) combo without
        leaving int16.  Each H, X and Y of DP row r and column c is the
        score of an alignment path (or a candidate one step longer) of at
        most r + c steps, each changing it by at most ``step`` =
        max(max|sub|, |gap|, |open|, |extend|): a substitution, an open or
        an extension, and GA's border open + (k-1) max(open, extend) is
        such a path.  The sweep's rows reach at most Lk + KB - 1 (the
        last band's pad rows, and the shorter lane's pad rows, whose
        substitution is 0) and its columns Lc, so every value lies within
        (Lc + Lk + KB - 1) * step of zero.  SCORE_MIN's stand-in is -32768
        + |extend|: it takes one extension (to at least -32768) before a
        real value replaces it, and must stay at or below every real
        value, which holds when (Lc + Lk + KB + 1) * step <= 32768.  So
        the margin is KB + 1 steps; the bound is taken one below."""
        step = max(1, self.max_sub, *(abs(int(g)) for g in self.gaps))
        return (Lc + Lk + cuda_dp.KB + 1) * step <= 32767

    def _pick(self, blks: list) -> int:
        """The entry that takes one launch group of (index, block): the one
        with the fewest cells sent so far, ties to the lowest index, so the
        assignment is a function of the block stream alone."""
        k = 0
        if len(self.lanes) > 1:
            cells = self._lane_cells
            k = cells.index(min(cells))
            cells[k] += sum(map(self._cells, (blk for _, blk in blks)))
        self._lane_launches[k] += 1
        return k

    def _enqueue(self, dev: torch.Tensor, part: list, flusher: Flusher,
                 lane: int) -> None:
        """Narrowed scores of ``part``, a list of (global block index,
        block), -> host, then to ``flusher``.  On CUDA the copy goes to
        pinned memory on the entry's stream (the current one) and an event
        marks its completion, so the flusher waits only for this
        dispatch."""
        flat = dev.reshape(-1)
        event = None
        if self._cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = flat
        flusher.add(host, event, part, lane)

    def _fill_tiles(self, dp16: bool) -> int:
        """Tiles that fill the first entry's card in the tile kernel's
        int32 or 16-bit form (cuda_dp.tiles_to_fill)."""
        return cuda_dp.tiles_to_fill(self.devices[0], self.algo, dp16)

    def _tile_group(self, Lc: int, Lk: int, ntiles: int) -> int:
        """Tiles per tile-kernel launch for a combo of ``ntiles`` tiles.  On
        the card, as few launches as the flush cap allows, so each one keeps
        every SM busy (cuda_dp.tiles_per_launch); with several entries, a
        combo that fills more than one card is split into a launch per
        entry at least.  On the CPU the plain version holds a whole launch
        in memory, so the reference's geometry.pick_T groups them.  Launch
        grouping changes no block, id or schedule token."""
        if self._cuda:
            cap = FLUSH_PAIRS // (TILE_S * TILE_B)
            if len(self.lanes) > 1:
                share = -(-ntiles // len(self.lanes))
                fill = self._fill_tiles(self._dp16_ok(Lc, Lk))
                cap = min(cap, max(share, fill))
            return cuda_dp.tiles_per_launch(ntiles, cap)
        return geometry.pick_T(Lc, Lk)

    def _counter(self, kernel: str, blks: list):
        """The ``on_launch`` of a DP launch of (index, block) ``blks``: in a
        recorded run, a count of the launch (trace.Run.launch) with its
        valid pairs and true cells; None otherwise."""
        if not self._rec:
            return None
        return functools.partial(
            self._rec.launch, kernel, sum(blk.n_valid for _, blk in blks),
            sum(self._cells(blk) for _, blk in blks))

    def _dispatch_tiles(self, blks: list, ctx: tuple, flusher) -> None:
        """One tile-kernel launch for a group of (index, tile) on the entry
        ``_pick`` names: the only upload is the (T, 2) int32 descriptor
        array."""
        arrays, Lc, Lk = ctx
        k = self._pick(blks)
        lane = self.lanes[k]
        cw, km, kl = arrays[k]
        desc = np.asarray([blk.desc for _, blk in blks], np.int32)
        with lane.on():
            out = cuda_dp.align_tiles(
                self._put(desc, lane), cw, km, kl, lane.sub, lane.gaps,
                algo=self.algo, dp16=self._dp16_ok(Lc, Lk),
                on_launch=self._counter("align_tiles", blks),
            )
            if self._int16_ok(Lc, Lk):
                out = out.to(torch.int16)
            self._enqueue(out, blks, flusher, k)

    def _dispatch_pairs(self, blks: list, ctx: tuple, flusher) -> None:
        """One per-pair launch for equal-width (index, block) pairs
        (linear-v1 superblocks or diagonal-remainder blocks) on the entry
        ``_pick`` names: one int64 start id per block goes up, ``rows_of``
        inverts the ids to bucket rows on the device."""
        arrays, rows_of, Lc, Lk = ctx
        k = self._pick(blks)
        lane = self.lanes[k]
        (mat_c, lens_c), (mat_k, lens_k) = arrays[k]
        width = blks[0][1].width
        with lane.on():
            starts = self._put(np.asarray([b.start for _, b in blks],
                                          np.int64), lane)
            lin = (starts[:, None] + torch.arange(width, device=lane.device)
                   ).reshape(-1)
            rc, rk = rows_of(lin)
            out = cuda_dp.align_pairs(
                mat_c, mat_k, rc, rk, lens_c, lens_k, lane.sub, lane.gaps,
                algo=self.algo, on_launch=self._counter("align_pairs", blks),
            )
            if self._int16_ok(Lc, Lk):
                out = out.to(torch.int16)
            self._enqueue(out, blks, flusher, k)

    def align_all(
        self,
        ss: SequenceSet,
        store: OutputStore | None,
        *,
        progress: bool = True,
        partition: tuple[int, int] | None = None,
        merger=None,
        journal=None,
        limit_pairs: int | None = None,
    ) -> AlignStats:
        """Score the whole pair space into ``store`` (None, as with the
        CLI's -W: scores are fetched and counted but not kept).

        partition: (host_id, nhosts): this host scores the blocks that the
        reference's least-loaded striping gives it (each block to the host
        with the fewest cells so far, ties to the lowest id); every host
        walks the same block stream, so flush points count all blocks.
        merger: callable (i, j, scores) -> (i, j, scores) applied at every
        flush point, on the main thread, even with nothing to flush (the
        multi-host exchange: parallel.multihost.TripletMerger, or
        parallel.shard_store.TripletRouter with a ShardStore as ``store``).
        journal: checkpoint.Journal; blocks whose global index it holds are
        skipped (their scores are already in a persistent store, and are
        read back for the merger), and every flushed block's index is
        committed at the next sync point (SYNC_INTERVAL), after the store
        is synced.
        limit_pairs: stop scheduling once this many pairs are claimed (the
        last block is finished, skipped blocks count), as the reference's
        benchmarking cut.

        With SEQALIGN_TPU_DEBUG_PHASES set, the call records its spans and
        DP launches into ``trace.runs()`` (trace.py lists them) and prints
        the reference's ``[phases]`` line at the end (``trace.phase_line``)."""
        kw = dict(progress=progress, partition=partition, merger=merger,
                  journal=journal, limit_pairs=limit_pairs)
        if not os.environ.get("SEQALIGN_TPU_DEBUG_PHASES"):
            return self._align_all(ss, store, None, **kw)
        with trace.Run() as rec:
            return self._align_all(ss, store, rec, **kw)

    def _align_all(self, ss, store, rec, *, progress, partition, merger,
                   journal, limit_pairs) -> AlignStats:
        """align_all's body; ``rec`` is the trace.Run that records its
        spans, or None."""
        host_id, nhosts = partition if partition else (0, 1)
        sched = Schedule.build(ss.lengths)
        tiles = self._tiles(sched)
        total_pairs = sched.total_pairs()
        ui.pinfo("Performing %d pairwise alignments", total_pairs)
        bar = ui.Progress(total_pairs, "Aligning sequences") if progress else None
        stats = AlignStats()
        # The walk's state (flusher, inflight, ...) is set in engine.dispatch.

        def flush(cause: str) -> None:
            nonlocal inflight
            flusher.flush(cause)
            inflight = 0

        def pace(dispatch) -> None:
            """Flush at FLUSH_PAIRS; otherwise, without a merger, when the
            flusher is idle and dispatches are in flight, start fetching
            them now (eager overlap: only the last dispatch's copy lands
            after the loop).  Under a merger only the global FLUSH_PAIRS
            points flush, so every host reaches the same ones."""
            if inflight >= FLUSH_PAIRS:
                dispatch()
                flush("forced")
            elif merger is None and flusher.ready():
                flush("eager")

        def reached() -> bool:
            return limit_pairs is not None and scheduled >= limit_pairs

        def take(blk):
            """The global index of the schedule's next block, or None when
            another host owns it or the journal holds it (its pairs count as
            resumed; the flusher re-contributes its stored scores to a
            merger).  Every block the schedule yields passes here once, in
            schedule order, before any grouping."""
            nonlocal gidx
            idx = gidx
            gidx += 1
            if nhosts > 1:
                owner = int(np.argmin(loads))
                loads[owner] += self._cells(blk)
                if owner != host_id:
                    if bar:
                        bar.add(blk.n_valid)  # another host's work
                    return None
            if journal is not None and idx in journal.done:
                stats.pairs_resumed += blk.n_valid
                flusher.resume(blk)
                if bar:
                    bar.add(blk.n_valid)
                return None
            return idx

        def stream(blocks, dispatch, group_max: int = 0,
                   whole: bool = False) -> None:
            """Send one combo's blocks that this host scores to ``dispatch``
            in groups of equal width (at most group_max blocks, 0 for no
            cap), pacing flushes; stops once limit_pairs is reached.
            Skipped blocks (another host's, or journaled) count towards the
            flush and limit points as the reference counts them.  With
            ``whole`` (the tile stream, whose launches are sized to fill
            the card) and no merger, a group that would cross FLUSH_PAIRS
            flushes before it starts, so the flush bound never cuts that
            launch short; under a merger that flush would depend on
            ownership, so it is not made."""
            nonlocal inflight, scheduled
            group: list = []

            def send():
                nonlocal group
                if group:
                    dispatch(group)
                    group = []

            for blk in blocks:
                if group and blk.width != group[0][1].width:
                    send()
                idx = take(blk)
                if (idx is not None and whole and merger is None and not group
                        and inflight
                        and inflight + group_max * blk.width > FLUSH_PAIRS):
                    flush("forced")
                inflight += blk.width
                scheduled += blk.n_valid
                if idx is not None:
                    group.append((idx, blk))
                if reached():
                    break
                if group_max and len(group) >= group_max:
                    send()
                pace(send)
            send()

        t0 = time.perf_counter()
        with trace.span(rec, "engine.pack") as sp:
            hit = self._bucket_cache is not None and self._bucket_cache[0] is ss
            if hit:
                buckets = self._bucket_cache[1]
            else:
                buckets = self._bucket_arrays(ss, sched, tiles)
                self._bucket_cache = (ss, buckets)
            if sp:
                sp.attrs = {"buckets": 0 if hit else len(sched.buckets),
                            "h2d_bytes": 0 if hit or not self._cuda else sum(
                                t.nbytes for lane in buckets
                                for codes, outer in lane
                                for t in (*codes, *(outer or ())))}
        with trace.span(rec, "engine.dispatch") as sp:
            self._lane_launches = [0] * len(self.lanes)
            self._lane_cells = [0] * len(self.lanes)
            # Block cells are counted only where something reads them:
            # _pick over several entries, the striping over hosts, the
            # launch counts.
            self._cells = (_BlockCells(sched) if rec or nhosts > 1
                           or len(self.lanes) > 1 else None)
            self._rec = rec
            flusher = Flusher(store, merger=merger, journal=journal,
                              stats=stats, rec=rec, bar=bar,
                              sync_interval=SYNC_INTERVAL)
            flusher.parent = sp
            inflight = 0  # pairs of width since the last flush
            scheduled = 0  # pairs claimed so far (limit_pairs)
            gidx = 0  # global index of the next block the schedule yields
            loads = np.zeros(nhosts, np.int64)  # cells owned per host
            for a, b in sched.combos():
                if reached():
                    break
                npairs = sched.combo_pair_count(a, b)
                if npairs == 0:
                    continue
                Lk = sched.buckets[a].edge
                Lc = sched.buckets[b].edge
                if not tiles:
                    # linear-v1: superblocks of consecutive pair ids.
                    rows = sched.buckets[a].count
                    if rows > (1 << 24):
                        raise RuntimeError(
                            f"bucket of {rows} rows exceeds the f32 pair-id "
                            "inversion range; build the schedule with "
                            "Schedule.build (which splits oversized buckets)"
                        )
                    width, B = self._superblock_width(Lc, Lk, npairs)
                    ctx = ([(bl[b][0], bl[a][0]) for bl in buckets],
                           functools.partial(_pair_rows, npairs=npairs,
                                             rows=rows, tri=a == b), Lc, Lk)
                    chunk = max(1, FLUSH_PAIRS // width)
                    stream(
                        sched.blocks(a, b, width=width, tail_min=B or None),
                        lambda g: self._dispatch_pairs(g, ctx, flusher),
                        1 << (chunk.bit_length() - 1),
                    )
                    continue
                tctx = ([(bl[b][1][0], bl[a][1][1], bl[a][1][2])
                         for bl in buckets], Lc, Lk)
                tiles_ab = list(sched.tiles(a, b))
                stream(tiles_ab,
                       lambda g: self._dispatch_tiles(g, tctx, flusher),
                       self._tile_group(Lc, Lk, len(tiles_ab)), whole=True)
                if a != b or reached():
                    continue
                # Diagonal remainder: the per-window triangles excluded from
                # the tile stream (Schedule.tiles), through the per-pair
                # kernel.
                count = sched.buckets[a].count
                n_slots = -(-count // TILE_B) * TRI_W
                ctx = ([(bl[a][0], bl[a][0]) for bl in buckets],
                       functools.partial(_diag_rows, n_slots=n_slots,
                                         rows=count), Lc, Lc)
                stream(
                    sched.diag_blocks(a, self._diag_width(Lc, n_slots),
                                      tail_min=TILE_B),
                    lambda g: self._dispatch_pairs(g, ctx, flusher),
                )
            if sp:
                sp.attrs = {"launches": list(self._lane_launches)}
        with trace.span(rec, "engine.final") as sp:
            flusher.finish(sp)
        if bar:
            bar.end()
        stats.seconds = time.perf_counter() - t0
        stats.lane_launches = list(self._lane_launches)
        stats.lane_cells = (list(self._lane_cells) if len(self.lanes) > 1
                            else [stats.cells])
        trace.finish(rec, stats.seconds, flusher.keep, pairs=stats.pairs,
                     cells=stats.cells, lanes=len(self.lanes),
                     schedule="tiles-v2" if tiles else "linear-v1")
        return stats
