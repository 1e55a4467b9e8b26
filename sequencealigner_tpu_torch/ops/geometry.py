"""Bucket geometry and host-side packing of the DP kernels (numpy only).

The numpy half of the reference's ``sequencealigner_tpu/ops/pallas_dp.py``:
the constants and helpers that decide which bucket combos the kernels take,
how many tiles one dispatch carries and what ``Engine.schedule_token``
hashes.  They must stay bit-identical to the reference, because journals and
tests compare schedules across the two packages; the CUDA kernels themselves
do not depend on the band height or column chunk chosen here.
"""

from __future__ import annotations

import numpy as np

#: Code of the pad character (one past the 24-letter alphabet).
PAD = 24
#: Substitution score of any pad-involving cell in the (25, 25) padded matrix.
BIG_NEG = -(2**28)
#: int8 marker for pad/invalid cells of an int8 score grid.
PAD_MARK = -128

LANE = 128
#: Per-chunk byte budget that fixes the column chunk CD (see geometry).
CHUNK_BYTES = 2 << 20

#: Default band height.  See band_kb.
KB = 32

#: Largest band height band_kb may return; geometry()'s chunk budget is
#: computed for this height, so the two must stay in lockstep.
KB_MAX = 64

#: Longest padded column count the kernels' schedule accepts; longer
#: buckets take the linear-v1 schedule, which the port does not have yet.
W_MAX = 4096

#: c-rows per outer-product tile: one tile pairs S_TILE consecutive c-side
#: bucket rows against one 128-lane window of k-side rows.
S_TILE = 128


def band_kb(Lk: int) -> int:
    """Band height for a given row count: 64 whenever that does not inflate
    Kpad beyond the 32-band rounding, else 32."""
    if Lk > 32 and round_up(Lk, KB_MAX) == round_up(Lk, 32):
        return KB_MAX
    return 32


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def geometry(Lc: int, Lk: int, B: int) -> tuple[int, int, int, int]:
    """(nb, Kpad, CD, W): band count, padded row count, column chunk, padded
    column count.  CD is a function of Lc only, so a bucket's c-side layout
    is the same in every combo it appears in."""
    kb = band_kb(Lk)
    assert kb <= KB_MAX, (kb, Lk)
    nb = -(-Lk // kb)
    Kpad = nb * kb
    cap = max(8, CHUNK_BYTES // (KB_MAX * B) // 8 * 8)
    wmin = round_up(Lc, 8)
    if cap >= wmin:
        CD = wmin
    else:
        nchunks = -(-wmin // cap)
        CD = round_up(-(-wmin // nchunks), 8)
    return nb, Kpad, CD, round_up(Lc, CD)


def pick_S(B: int, Kpad: int, W: int, target_cells: int = 1 << 31) -> int:
    """Superblock height of a per-pair dispatch, sized by padded cells."""
    s = target_cells // (B * Kpad * W)
    return max(1, min(2048, int(s)))


def supports(Lc: int, Lk: int) -> bool:
    """Whether the tile schedule covers this bucket combo (W <= W_MAX)."""
    nb, Kpad, CD, W = geometry(Lc, Lk, LANE)
    return W <= W_MAX


def pick_T(Lc: int, Lk: int, target_cells: int = 1 << 31, t_max: int = 256):
    """Tiles per dispatch: sized by padded cells like pick_S, capped, and
    rounded down to a power of two."""
    nb, Kpad, CD, W = geometry(Lc, Lk, LANE)
    tile = S_TILE * LANE * Kpad * W
    t = max(1, min(t_max, target_cells // tile))
    return 1 << (int(t).bit_length() - 1)


def pack_bucket_outer(mat: np.ndarray, lengths: np.ndarray, edge: int):
    """Host-side per-bucket arrays of the tile kernel, built once per bucket:

      cwords: (count_padS, 1 + W//4) int32 -- row r = [true length | codes
        byte-packed 4/word in plain order (code w = byte w%4 of word w//4)].
        Rows are padded to a multiple of S_TILE plus one extra tile of
        all-PAD/length-0 rows, so tail tiles and dummy descriptor rows always
        index in bounds and score as discardable zeros.
      kmatT: (Kpad, count_pad128) int8 -- the transposed code matrix:
        column b = sequence b's codes (PAD beyond its length and count).
      klens: (1, count_pad128) int32 -- true lengths (0 at pad lanes).

    Returns None when the bucket is too long (W > W_MAX)."""
    nb, Kpad, CD, W = geometry(edge, edge, LANE)
    if W > W_MAX:
        return None
    count = mat.shape[0]
    rows = round_up(max(count, 1), S_TILE) + S_TILE
    m = np.full((rows, W), PAD, np.int8)
    m[:count, :edge] = mat[:, :edge]
    cwords = np.zeros((rows, 1 + W // 4), np.int32)
    cwords[:count, 0] = lengths[:count]
    cwords[:, 1:] = np.ascontiguousarray(m).view(np.int32)
    cols = round_up(max(count, 1), LANE)
    kT = np.full((Kpad, cols), PAD, np.int8)
    kT[:edge, :count] = mat[:, :edge].T
    klens = np.zeros((1, cols), np.int32)
    klens[0, :count] = lengths[:count]
    return cwords, kT, klens
