"""Similarity prefilter: greedy positional-identity dedup before alignment.

Port of ``sequencealigner_tpu/filter.py``.  Sequence j is dropped iff some
KEPT i < j has matches / min(len_i, len_j) >= threshold (float32 division),
where matches counts positionally equal characters over the first min(len)
positions, resolved strictly in file order (reference src/bio/filter.c:14-89
made deterministic).

- **Match counting as a matrix product.**  Positional identity is a dot
  product of one-hot encodings: counts = OH_i . OH_j^T with OH = (rows,
  L x 24); pad positions (code -1) one-hot to the zero vector, so pad never
  matches.  The one-hots are float32: 0/1 terms and their sums are exact
  below 2^24, with or without TF32 (a bf16 product would round 257 to 256).
- **Device-reduced prior verdicts, segment batching.**  Candidates go in
  segments of SEG_BLOCKS blocks; their comparison against every PRIOR row
  is reduced on the device against the current kept mask, so per segment
  one bool per candidate and the (seg x seg) local verdicts reach the host,
  which resolves the greedy within the segment (io/native.filter_resolve,
  NumPy fallback).
- **Length-bucketed residency.**  Prior rows stay on the device as
  per-bucket (count, edge) code matrices (the engine's Schedule buckets);
  a cross-length product contracts over min(edge, lmax) positions only,
  which is exact because positions past the shorter sequence are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ui
from .io.input import SequenceSet

#: Blocks per dispatch segment: larger segments amortize host round trips.
SEG_BLOCKS = 8

#: One-hot bytes budget for a candidate segment (bounds its (S, lmax * 24)
#: float32 one-hot; segments shrink for very long sequence sets).
SEG_OH_BYTES = 1 << 30

#: Bytes of one position's one-hot: 24 codes of float32.
OH_BYTES = 24 * 4


def _onehot_flat(rows: torch.Tensor) -> torch.Tensor:
    """(r, L) int8 codes -> (r, L * 24) float32 one-hots; -1 (pad) -> 0."""
    codes = torch.arange(24, dtype=rows.dtype, device=rows.device)
    return (rows[:, :, None] == codes).to(torch.float32).reshape(
        rows.shape[0], rows.shape[1] * 24)


def _similar(counts, rowlens, collens, thr):
    """counts / max(minlen, 1) >= thr in float32; False where minlen is 0."""
    minlen = torch.minimum(rowlens[:, None], collens[None, :])
    return (minlen > 0) & (
        counts / torch.clamp_min(minlen, 1).to(torch.float32) >= thr)


def _filter_segment(cols, collens, kept, thr, j0: int, buckets, block: int):
    """One candidate segment (cols: (s, lmax) int8 codes, -1 at pad) against
    every prior row and itself.

    buckets: per bucket (codes (cnt_pad, edge) int8, lens (cnt_pad,) int32,
    0 on pad rows, orig (cnt_pad,) int64, n on pad rows).  kept: (n + 1,)
    bool with kept[n] False, final below j0.  Returns killed_prior (s,) bool
    and sim_local (s, s) bool, on the device."""
    lmax = cols.shape[1]
    colflat = _onehot_flat(cols)
    killed = torch.zeros(cols.shape[0], dtype=torch.bool, device=cols.device)
    for codes_b, lens_b, orig_b in buckets:
        w = min(codes_b.shape[1], lmax)
        colpart = colflat[:, : w * 24]
        # The full scan, masked per row by (orig < j0) and kept.
        for i0 in range(0, codes_b.shape[0], block):
            orig = orig_b[i0 : i0 + block]
            counts = _onehot_flat(codes_b[i0 : i0 + block, :w]) @ colpart.T
            prior = _similar(counts, lens_b[i0 : i0 + block], collens, thr)
            prior &= (kept[orig] & (orig < j0))[:, None]
            killed |= prior.any(dim=0)
    sim_local = _similar(colflat @ colflat.T, collens, collens, thr)
    return killed, sim_local


def _pack_codes(ss: SequenceSet, rows: np.ndarray, edge: int) -> np.ndarray:
    """(len(rows), edge) int8 compact codes (0..23; -1 at pad) for the given
    original indices: native fused pass, NumPy fallback."""
    from .io import native

    mat = native.pack_rows(ss.data, ss.offsets, rows, edge, ss.lut, -1)
    if mat is None:
        mat = np.full((len(rows), edge), -1, dtype=np.int8)
        for local, orig in enumerate(rows):
            s = ss.data[ss.offsets[orig] : ss.offsets[orig + 1]]
            mat[local, : len(s)] = ss.lut[s].astype(np.int8)
    return mat


def filter_sequences(
    ss: SequenceSet, threshold: float, *, block: int = 512,
    progress: bool = True, device="cuda",
) -> tuple[SequenceSet, int]:
    """Returns (filtered set, number dropped); the filtered set's ``kept``
    holds the survivors' original indices.  device: "cuda" (the card) or
    "cpu"."""
    if threshold <= 0.0:
        return ss, 0

    from .io import native
    from .scheduler import Schedule

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    n = ss.num
    lmax = int(ss.max_len)
    seg_blocks = max(1, min(SEG_BLOCKS,
                            SEG_OH_BYTES // (block * lmax * OH_BYTES)))
    S = block * seg_blocks

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # Per-bucket device residency (see module notes).
    sched = Schedule.build(ss.lengths)
    buckets = []
    for b in sched.buckets:
        rows = sched.order[b.start : b.end]
        cnt = len(rows)
        cpad = -(-cnt // block) * block
        mat = np.full((cpad, b.edge), -1, dtype=np.int8)
        mat[:cnt] = _pack_codes(ss, rows, b.edge)
        lens = np.zeros(cpad, np.int32)
        lens[:cnt] = ss.lengths[rows]
        orig = np.full(cpad, n, np.int64)
        orig[:cnt] = rows
        buckets.append((put(mat), put(lens), put(orig)))

    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    lost = np.zeros(n, dtype=np.uint8)
    kept = np.ones(n + 1, dtype=bool)
    kept[n] = False  # pad rows resolve against this slot
    bar = ui.Progress(n - 1, "Filtering sequences") if progress else None

    for j0 in range(0, n, S):
        j1 = min(j0 + S, n)
        bsz = j1 - j0
        cols = _pack_codes(ss, np.arange(j0, j1, dtype=np.int64), lmax)
        killed, sim_local = _filter_segment(
            put(cols), put(ss.lengths[j0:j1].astype(np.int32)), put(kept),
            thr, j0, buckets, block,
        )
        # Host greedy within the segment, with the device-reduced prior
        # verdict folded in as a SENTINEL row 0 (a permanently kept pseudo
        # sequence similar to every prior-killed candidate), so cascading
        # works: a candidate killed by a prior block cannot itself kill.
        aug = np.zeros((bsz + 1, bsz), np.uint8)
        aug[0] = killed.cpu().numpy()
        aug[1:] = sim_local.cpu().numpy()
        loc_lost = np.zeros(bsz + 1, np.uint8)
        if not native.filter_resolve(aug, loc_lost, 1, bsz + 1):
            lb = loc_lost.view(bool)
            augb = aug.view(bool)
            for j in range(1, bsz + 1):
                lb[j] = bool(np.any(augb[:j, j - 1] & ~lb[:j]))
        lost[j0:j1] = loc_lost[1:]
        kept[j0:j1] = lost[j0:j1] == 0
        if bar:
            bar.add(bsz)
    if bar:
        bar.end()

    lost = lost.view(bool)[:n]
    dropped = int(lost.sum())
    if dropped == 0:
        ss.kept = np.arange(n, dtype=np.int64)
        return ss, 0
    keep = np.flatnonzero(~lost)
    seqs = [ss.data[ss.offsets[i] : ss.offsets[i + 1]] for i in keep]
    out = SequenceSet.from_list(seqs, ss.lut)
    out.kept = keep.astype(np.int64)  # original indices of the survivors
    return out, dropped
