# Copy of sequencealigner_tpu/scheduler.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Pair-space scheduler: linear pair index, length buckets, lazy block stream.

The reference enumerates the N(N-1)/2 pair space linearly and maps ids to
(i, j) with a triangular-number bisection (d_find_j,
reference src/bio/kernels.cu:17-30; packed index alignments(j)+i,
util/macros.h:13).  We keep that bijection for storage, but *schedule* pairs
by length bucket so each compiled TPU kernel shape runs densely padded blocks:

- sequences are sorted by length; each bucket is a contiguous range of the
  sorted order, padded to a quantized edge length
- a bucket-combo (a <= b) owns the rectangle (triangle when a == b) of sorted
  pair space {i in bucket a, j in bucket b}; blocks of B pairs are generated
  lazily by arithmetic, so nothing O(N^2) is ever materialized
- within a pair, the LONGER sequence is the DP column dimension (Lc) and the
  shorter the row/state dimension (Lk <= Lc), shrinking the wavefront state
  (scores are symmetric, verified in tests)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def pair_count(n: int) -> int:
    return n * (n - 1) // 2


def pair_to_linear(i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """(i < j) -> linear id = alignments(j) + i."""
    j = j.astype(np.int64)
    return j * (j - 1) // 2 + i


def linear_to_pair(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse bijection (the vectorized d_find_j)."""
    ids = np.asarray(ids, dtype=np.int64)
    # j = floor((1 + sqrt(1 + 8 id)) / 2), with integer correction for fp error.
    j = ((1.0 + np.sqrt(1.0 + 8.0 * ids.astype(np.float64))) / 2.0).astype(np.int64)
    j = np.where(j * (j - 1) // 2 > ids, j - 1, j)
    j = np.where((j + 1) * j // 2 <= ids, j + 1, j)
    i = ids - j * (j - 1) // 2
    return i, j


# Length edges: the column-sweep kernel pads rows to multiples of KB = 32
# but columns only to multiples of 8, so edges need not be 32-multiples.
# The short end stays COARSE: every extra edge multiplies bucket combos and
# hence dispatches, and short-sequence runs are dispatch/host-bound (adding
# a 48 edge measured a net e2e LOSS on the 1k-protein bench).  The long end
# gets intermediate edges (160, 320, 640): there device time dominates and
# ~1.3x spacing cuts real padded work.
DEFAULT_EDGES = (
    16, 24, 32, 64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768,
    1024, 1536, 2048, 3072, 4096, 6144, 8192,
)

#: Target DP cells per device per block; B is derived from this.
TARGET_CELLS = 1 << 24
B_MIN, B_MAX = 8, 4096

#: Max rows per bucket: the engine's on-device triangle inversion
#: (engine._gather_pairs) uses an f32 sqrt whose two-step integer correction
#: is exact only while bucket rows fit f32 exactly (~2^24).  Oversized
#: buckets are SPLIT into same-edge chunks at schedule build — chunk pairs
#: become ordinary rectangle combos, every path stays exact (the reference
#: instead bisects in full s64 per pair, src/bio/kernels.cu:17-30).
BUCKET_ROWS_MAX = 1 << 24


def block_width(Lc: int, Lk: int, target_cells: int = TARGET_CELLS) -> int:
    b = target_cells // (Lc * Lk)
    b = 1 << max(int(b).bit_length() - 1, 0)  # round down to a power of two
    return max(B_MIN, min(B_MAX, b))


def bucket_edges(max_len: int, edges=DEFAULT_EDGES) -> list[int]:
    out = [e for e in edges if e < max_len]
    grow = list(edges)
    while grow[-1] < max_len:  # extend ~1.5x, kept a multiple of 32
        nxt = grow[-1] + grow[-1] // 2
        grow.append((nxt + 31) // 32 * 32)
    out.append(next(x for x in grow if x >= max_len))
    return sorted(set(out))


@dataclasses.dataclass
class Bucket:
    edge: int  # padded length
    start: int  # range [start, end) in the sorted order
    end: int

    @property
    def count(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class Block:
    """One kernel invocation's worth of pairs (padded to width B).

    LAZY: only arithmetic identity (combo, start, width, n_valid) is carried;
    the per-pair arrays (original indices, lengths, validity) are materialized
    on first access — the engine ships just ``start`` to the device and needs
    the arrays only at flush time, on the background flusher thread, so the
    dispatch path never pays per-pair numpy work (~70 ms of a ~160 ms 1k-seq
    run before this)."""

    Lc: int
    Lk: int
    start: int  # first combo-local linear pair id of this block
    bucket_c: int  # bucket index of the column (longer) sequences
    bucket_k: int
    width: int  # padded pair count B
    n_valid: int  # real pairs (the rest are padding)
    sched: "Schedule" = dataclasses.field(repr=False)
    _arr: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _pairs: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def arrays(self) -> tuple:
        """(orig_i, orig_j, l1, l2, valid), materialized once."""
        if self._arr is None:
            sch = self.sched
            ba = sch.buckets[self.bucket_k]
            bb = sch.buckets[self.bucket_c]
            valid = np.arange(self.width) < self.n_valid
            lin = np.arange(self.start, self.start + self.width,
                            dtype=np.int64)
            lin = np.where(valid, lin, 0)  # pad -> dummy pair (0, 0)
            if self.bucket_k == self.bucket_c:
                rk, rc = linear_to_pair(lin)  # local triangle coords
            else:
                rk = lin % ba.count
                rc = lin // ba.count
            sk = ba.start + rk  # sorted-order indices
            sc = bb.start + rc
            ok = sch.order[sk]
            oc = sch.order[sc]
            oi = np.minimum(ok, oc).astype(np.int64)
            oj = np.maximum(ok, oc).astype(np.int64)
            l1 = sch.lengths_sorted[sc].astype(np.int32)
            l2 = sch.lengths_sorted[sk].astype(np.int32)
            self._arr = (oi, oj, l1, l2, valid)
        return self._arr

    @property
    def orig_i(self) -> np.ndarray:
        return self.arrays()[0]

    @property
    def orig_j(self) -> np.ndarray:
        return self.arrays()[1]

    @property
    def l1(self) -> np.ndarray:
        return self.arrays()[2]

    @property
    def l2(self) -> np.ndarray:
        return self.arrays()[3]

    @property
    def valid(self) -> np.ndarray:
        return self.arrays()[4]

    @property
    def cells(self) -> int:
        _, _, l1, l2, valid = self.arrays()
        return int((l1.astype(np.int64) * l2)[valid].sum())

    def select_valid(self, scores: np.ndarray) -> np.ndarray:
        """The valid-pair slice of this block's score slots (linear blocks
        put valid pairs first; tile blocks scatter them — see TileBlock)."""
        return scores[: self.n_valid]

    def pairs(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(orig_i, orig_j, cells) over the VALID pairs only — the flush-side
        form, via the fused C pass (io/native.py materialize_block) when
        available."""
        if self._pairs is None:
            r = None
            if self._arr is None:
                from .io import native

                sch = self.sched
                ba = sch.buckets[self.bucket_k]
                bb = sch.buckets[self.bucket_c]
                r = native.materialize_block(
                    sch.order, sch.lengths_sorted, ba.start, ba.count,
                    bb.start, self.bucket_k == self.bucket_c,
                    self.start, self.n_valid,
                )
            if r is None:
                oi, oj, _, _, valid = self.arrays()
                r = (oi[valid], oj[valid], self.cells)
            self._pairs = r
        return self._pairs


#: Outer-product tile geometry (must match ops.pallas_dp.S_TILE / LANE;
#: asserted by the engine).  Kept as plain ints so the scheduler stays
#: numpy-only.
TILE_S = 128
TILE_B = 128

#: Slot ids per window in the diagonal-remainder subspace (diag_blocks):
#: the triangle of one TILE_B-row window.
TRI_W = TILE_B * (TILE_B - 1) // 2


@dataclasses.dataclass
class DiagBlock:
    """One per-pair dispatch's worth of DIAGONAL-REMAINDER pairs of a
    same-bucket combo under the tile schedule (see Schedule.diag_blocks).
    Slot id t -> window u = t // TRI_W, local triangle id loc = t - u*TRI_W,
    (rk, rc) = u*TILE_B + linear_to_pair(loc).  Tail-window slots whose rows
    exceed the bucket count are invalid (masked here, clamped on device).
    The packed-triangular STORAGE bijection (reference util/macros.h:13) is
    unchanged — only the schedule geometry differs."""

    edge: int
    bucket: int
    start: int  # first diag-subspace slot id
    width: int  # padded slot count (multiple of the lane width)
    sched: "Schedule" = dataclasses.field(repr=False)
    _arr: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _pairs: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _nv: int | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def Lc(self) -> int:
        return self.edge

    @property
    def Lk(self) -> int:
        return self.edge

    def arrays(self) -> tuple:
        """(orig_i, orig_j, l1, l2, valid) over all width slots."""
        if self._arr is None:
            sch = self.sched
            ba = sch.buckets[self.bucket]
            t = np.arange(self.start, self.start + self.width, dtype=np.int64)
            u = t // TRI_W
            loc = t - u * TRI_W
            rk, rc = linear_to_pair(loc)  # local window triangle, rk < rc
            rc = u * TILE_B + rc
            rk = u * TILE_B + rk
            nwin = -(-ba.count // TILE_B)
            valid = (t < nwin * TRI_W) & (rc < ba.count)
            rcc = np.minimum(rc, ba.count - 1)
            rkk = np.minimum(rk, ba.count - 1)
            ok = sch.order[ba.start + rkk]
            oc = sch.order[ba.start + rcc]
            oi = np.minimum(ok, oc).astype(np.int64)
            oj = np.maximum(ok, oc).astype(np.int64)
            l1 = sch.lengths_sorted[ba.start + rcc].astype(np.int32)
            l2 = sch.lengths_sorted[ba.start + rkk].astype(np.int32)
            self._arr = (oi, oj, l1, l2, valid)
        return self._arr

    orig_i = property(lambda self: self.arrays()[0])
    orig_j = property(lambda self: self.arrays()[1])
    l1 = property(lambda self: self.arrays()[2])
    l2 = property(lambda self: self.arrays()[3])
    valid = property(lambda self: self.arrays()[4])

    @property
    def n_valid(self) -> int:
        """Analytic (no 16k-slot array materialization — this is read on the
        MAIN thread during scheduling): slot t of window u is valid iff its
        local triangle id < tri(m_u), m_u = clip(count - u*TILE_B, 0, TILE_B)
        — j(loc) is nondecreasing in loc, so validity is a prefix."""
        if self._nv is None:
            count = self.sched.buckets[self.bucket].count
            lo, hi = self.start, self.start + self.width
            total = 0
            for u in range(lo // TRI_W, (hi - 1) // TRI_W + 1):
                m = min(TILE_B, count - u * TILE_B)
                if m < 2:
                    continue
                tri = m * (m - 1) // 2
                a = max(lo - u * TRI_W, 0)
                b = min(hi - u * TRI_W, TRI_W)
                if a < tri:
                    total += min(b, tri) - a
            self._nv = total
        return self._nv

    @property
    def cells(self) -> int:
        _, _, l1, l2, valid = self.arrays()
        return int((l1.astype(np.int64) * l2)[valid].sum())

    def select_valid(self, scores: np.ndarray) -> np.ndarray:
        """Valid-slot scores (tail-window invalid slots are interspersed,
        so selection is by mask, like TileBlock)."""
        return scores[self.arrays()[4]]

    def pairs(self) -> tuple[np.ndarray, np.ndarray, int]:
        if self._pairs is None:
            oi, oj, _, _, valid = self.arrays()
            self._pairs = (oi[valid], oj[valid], self.cells)
        return self._pairs


@dataclasses.dataclass
class TileBlock:
    """One OUTER-PRODUCT tile: TILE_S consecutive c-side bucket rows crossed
    with one contiguous TILE_B-lane window of k-side bucket rows (the
    zero-gather schedule for ops.pallas_dp.align_outer).  The kernel computes
    the full rectangle; validity — tail rows/lanes past the bucket counts and
    the k<c triangle constraint of same-bucket combos — is applied here, on
    the host, when slicing scores out of the dispatch buffer.

    Covers the same pair space as the linear-id Blocks (the packed-triangular
    bijection of reference src/util/macros.h:13 is still used for
    STORAGE); only the schedule geometry differs."""

    Lc: int
    Lk: int
    bucket_c: int
    bucket_k: int
    c0: int  # first combo-local c row of the tile
    kt: int  # k-tile index: lane window [kt*TILE_B, (kt+1)*TILE_B)
    width: int  # TILE_S * TILE_B score slots (row-major: c-row, then lane)
    n_valid: int
    sched: "Schedule" = dataclasses.field(repr=False)
    _arr: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _pairs: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def desc(self) -> tuple[int, int]:
        """The (c-row, k-tile) descriptor the device dispatch ships."""
        return (self.c0, self.kt)

    def arrays(self) -> tuple:
        """(orig_i, orig_j, l1, l2, valid) over all width slots.  Interior
        tiles (n_valid == width: no tail rows/lanes, no diagonal constraint
        — the vast majority at scale) skip the mask arithmetic; valid is
        None for them and every slot is a pair."""
        if self._arr is None:
            sch = self.sched
            ba = sch.buckets[self.bucket_k]
            bb = sch.buckets[self.bucket_c]
            full = self.n_valid == self.width
            rc = np.repeat(
                np.arange(self.c0, self.c0 + TILE_S, dtype=np.int64), TILE_B
            )
            rk = np.tile(
                np.arange(self.kt * TILE_B, (self.kt + 1) * TILE_B,
                          dtype=np.int64),
                TILE_S,
            )
            if full:
                valid = None
                rcc, rkk = rc, rk
            else:
                valid = (rc < bb.count) & (rk < ba.count)
                if self.bucket_k == self.bucket_c:
                    valid &= rk < rc
                rcc = np.minimum(rc, bb.count - 1)
                rkk = np.minimum(rk, ba.count - 1)
            ok = sch.order[ba.start + rkk]
            oc = sch.order[bb.start + rcc]
            oi = np.minimum(ok, oc).astype(np.int64)
            oj = np.maximum(ok, oc).astype(np.int64)
            l1 = sch.lengths_sorted[bb.start + rcc].astype(np.int32)
            l2 = sch.lengths_sorted[ba.start + rkk].astype(np.int32)
            self._arr = (oi, oj, l1, l2, valid)
        return self._arr

    orig_i = property(lambda self: self.arrays()[0])
    orig_j = property(lambda self: self.arrays()[1])
    l1 = property(lambda self: self.arrays()[2])
    l2 = property(lambda self: self.arrays()[3])

    @property
    def valid(self):
        v = self.arrays()[4]
        return slice(None) if v is None else v

    @property
    def cells(self) -> int:
        """Analytic true-cell count: tiles-v2 rectangles have no diagonal
        masking (same-bucket tiles start at the NEXT window), so cells =
        (sum of c-side lengths) x (sum of k-side lengths) over the clipped
        row/lane ranges — two prefix-sum lookups, no slot arrays."""
        sch = self.sched
        ba = sch.buckets[self.bucket_k]
        bb = sch.buckets[self.bucket_c]
        ps = sch.length_psums()
        pc, pk = ps[self.bucket_c], ps[self.bucket_k]
        chi = min(self.c0 + TILE_S, bb.count)
        klo = self.kt * TILE_B
        khi = min(klo + TILE_B, ba.count)
        if chi <= self.c0 or khi <= klo:
            return 0
        return int((pc[chi] - pc[self.c0]) * (pk[khi] - pk[klo]))

    def select_valid(self, scores: np.ndarray) -> np.ndarray:
        """Valid-pair scores of a tile: selected by the mask (tail rows and
        lanes past the bucket counts, and the k >= c half of same-bucket
        diagonal tiles, are computed by the kernel but discarded here);
        interior tiles pass through unsliced."""
        v = self.arrays()[4]
        return scores if v is None else scores[v]

    def pairs(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(orig_i, orig_j, cells) over the VALID slots only."""
        if self._pairs is None:
            oi, oj, _, _, valid = self.arrays()
            if valid is None:
                self._pairs = (oi, oj, self.cells)
            else:
                self._pairs = (oi[valid], oj[valid], self.cells)
        return self._pairs


@dataclasses.dataclass
class Schedule:
    order: np.ndarray  # sorted-by-length permutation: order[s] = original index
    buckets: list[Bucket]
    lengths_sorted: np.ndarray
    _psums: list | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def length_psums(self) -> list:
        """Per-bucket prefix sums of sorted lengths (int64): psums[b][r] =
        sum of the first r lengths of bucket b — O(1) analytic cell counts
        for tile blocks."""
        if self._psums is None:
            self._psums = [
                np.concatenate((
                    [0],
                    np.cumsum(
                        self.lengths_sorted[b.start : b.end], dtype=np.int64
                    ),
                ))
                for b in self.buckets
            ]
        return self._psums

    @classmethod
    def build(cls, lengths: np.ndarray, edges=DEFAULT_EDGES) -> "Schedule":
        lengths = np.asarray(lengths, dtype=np.int32)
        order = np.argsort(lengths, kind="stable")
        ls = lengths[order]
        edge_list = bucket_edges(int(ls[-1]), edges)
        buckets = []
        start = 0
        for e in edge_list:
            end = int(np.searchsorted(ls, e, side="right"))
            if end > start:
                buckets.append(Bucket(edge=e, start=start, end=end))
                start = end
        # Merge tiny buckets upward: every bucket multiplies the combo count
        # (hence dispatches and compiled shapes), and a handful of sequences
        # in their own bucket cost more in per-combo overhead than their
        # extra padding in the next bucket does.  Beyond the hard floor, a
        # bucket under two tile windows merges whenever the next edge is at
        # most 2x its own: the outer kernel truncates DP columns at the true
        # c-row length, so the merge penalty is only the k-side band
        # padding on the merged rows (bounded by the edge ratio), while the
        # saved combo row costs real dispatches on every run.
        min_count = max(64, len(order) // 64)
        merged: list[Bucket] = []
        for b in buckets:
            if merged and (
                merged[-1].count < min_count
                or (merged[-1].count < 256 and b.edge <= 2 * merged[-1].edge)
            ):
                prev = merged.pop()
                b = Bucket(edge=b.edge, start=prev.start, end=b.end)
            merged.append(b)
        if len(merged) > 1 and merged[-1].count < min_count:
            last = merged.pop()
            prev = merged.pop()
            merged.append(Bucket(edge=last.edge, start=prev.start, end=last.end))
        split: list[Bucket] = []
        for b in merged:
            while b.count > BUCKET_ROWS_MAX:
                split.append(
                    Bucket(edge=b.edge, start=b.start, end=b.start + BUCKET_ROWS_MAX)
                )
                b = Bucket(edge=b.edge, start=b.start + BUCKET_ROWS_MAX, end=b.end)
            split.append(b)
        return cls(order=order, buckets=split, lengths_sorted=ls)

    def combos(self) -> list[tuple[int, int]]:
        """(k_bucket, c_bucket) combos with k <= c, in ascending-cost order."""
        nb = len(self.buckets)
        return [(a, b) for b in range(nb) for a in range(b + 1)]

    def combo_pair_count(self, a: int, b: int) -> int:
        if a == b:
            return pair_count(self.buckets[a].count)
        return self.buckets[a].count * self.buckets[b].count

    def total_pairs(self) -> int:
        n = len(self.order)
        return pair_count(n)

    def total_cells(self) -> int:
        ls = self.lengths_sorted.astype(np.int64)
        s1, s2 = ls.sum(), (ls * ls).sum()
        return int((s1 * s1 - s2) // 2)

    def blocks(
        self, a: int, b: int, width: int | None = None,
        target_cells: int = TARGET_CELLS, tail_min: int | None = None,
    ) -> Iterator[Block]:
        """Lazy blocks for combo (a <= b).  Pairs are (i_sorted from bucket a,
        j_sorted from bucket b); within-bucket (a == b) uses the triangle.

        tail_min: when set, the tail of the combo is covered by SHRINKING
        power-of-two-multiple-of-tail_min widths instead of one full-width
        padded block (a 262k-wide superblock over a 66k tail wastes 75% of
        its padded cells otherwise); widths stay in the pow2 compile set."""
        ba, bb = self.buckets[a], self.buckets[b]
        Lk, Lc = ba.edge, bb.edge
        B = width or block_width(Lc, Lk, target_cells)
        npairs = self.combo_pair_count(a, b)
        s0 = 0
        w = B
        while s0 < npairs:
            need = npairs - s0
            if tail_min and need < w:
                units = -(-need // tail_min)
                w = min(w, tail_min << max(0, (units - 1).bit_length()))
            yield Block(
                Lc=Lc,
                Lk=Lk,
                start=s0,
                bucket_c=b,
                bucket_k=a,
                width=w,
                n_valid=min(w, need),
                sched=self,
            )
            s0 += w

    def tiles(self, a: int, b: int) -> Iterator[TileBlock]:
        """Lazy OUTER-PRODUCT tiles for combo (a <= b): for each TILE_B-lane
        window of bucket a's rows, TILE_S-row chunks of bucket b's rows.
        Same-bucket combos emit ONLY the fully-below-diagonal rectangles
        (c-rows start at the NEXT window): the per-window diagonal triangles
        — which a tile could only cover half-valid, ~12.5% discarded compute
        at a 1k-sequence single-bucket space — are scheduled separately
        through the per-pair path (diag_blocks).  Tiles with zero valid
        pairs are skipped."""
        ba, bb = self.buckets[a], self.buckets[b]
        Lk, Lc = ba.edge, bb.edge
        same = a == b
        ntk = -(-ba.count // TILE_B)
        for kt in range(ntk):
            lanes = min(TILE_B, ba.count - kt * TILE_B)
            c_lo = (kt + 1) * TILE_B if same else 0
            for c0 in range(c_lo, bb.count, TILE_S):
                nv = min(TILE_S, bb.count - c0) * lanes
                if nv == 0:
                    continue
                yield TileBlock(
                    Lc=Lc, Lk=Lk, bucket_c=b, bucket_k=a, c0=c0, kt=kt,
                    width=TILE_S * TILE_B, n_valid=nv, sched=self,
                )

    def diag_blocks(
        self, a: int, width: int, tail_min: int | None = None,
    ) -> Iterator["DiagBlock"]:
        """The DIAGONAL remainder of same-bucket combo (a, a) under the tile
        schedule: each TILE_B-row window's own triangle, enumerated in a
        uniform per-window subspace of TRI_W = TILE_B*(TILE_B-1)/2 slot ids
        (window u owns ids [u*TRI_W, (u+1)*TRI_W); tail windows carry
        invalid tail slots, discarded by mask).  Dispatched through the
        per-pair packed path with mode='diag' — near-zero padded compute
        where a diagonal tile would discard half its slots."""
        count = self.buckets[a].count
        nwin = -(-count // TILE_B)
        if count < 2:
            return
        total = nwin * TRI_W
        s0 = 0
        w = width
        while s0 < total:
            need = total - s0
            if tail_min and need < w:
                units = -(-need // tail_min)
                w = min(w, tail_min << max(0, (units - 1).bit_length()))
            yield DiagBlock(
                edge=self.buckets[a].edge, bucket=a, start=s0, width=w,
                sched=self,
            )
            s0 += w
