# Copy of sequencealigner_tpu/ops/oracle.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""NumPy reference implementations of the three DP recurrences.

These are the correctness oracle for the TPU kernels: straightforward
row-major table fills implementing exactly the reference semantics
(Needleman-Wunsch linear gap: reference src/bio/method/nw.c:21-41;
Gotoh global affine: ga.c:26-67; Smith-Waterman local affine: sw.c:26-61).
Gap penalties are *stored negated* (<= 0) exactly like the reference CLI
(-p/-s/-e parse positive integers and negate, src/bio/align.c:127-128).

Sequences are index arrays (already mapped through the char LUT).
"""

from __future__ import annotations

import numpy as np

from ..matrices import SCORE_MIN


def nw_linear(s1: np.ndarray, s2: np.ndarray, sub: np.ndarray, gap: int) -> int:
    """Global alignment, linear gap penalty ``gap`` (<= 0)."""
    l1, l2 = len(s1), len(s2)
    h = np.zeros((l2 + 1, l1 + 1), dtype=np.int64)
    h[0, :] = np.arange(l1 + 1) * gap
    h[:, 0] = np.arange(l2 + 1) * gap
    for r in range(1, l2 + 1):
        row_sub = sub[s2[r - 1]]
        for c in range(1, l1 + 1):
            h[r, c] = max(
                h[r - 1, c - 1] + row_sub[s1[c - 1]],
                h[r - 1, c] + gap,
                h[r, c - 1] + gap,
            )
    return int(h[l2, l1])


def _affine_tables(l1: int, l2: int):
    h = np.zeros((l2 + 1, l1 + 1), dtype=np.int64)
    x = np.full((l2 + 1, l1 + 1), SCORE_MIN, dtype=np.int64)
    y = np.full((l2 + 1, l1 + 1), SCORE_MIN, dtype=np.int64)
    return h, x, y


def ga_affine(s1: np.ndarray, s2: np.ndarray, sub: np.ndarray, opn: int, ext: int) -> int:
    """Gotoh global alignment with affine gaps (opn, ext <= 0)."""
    l1, l2 = len(s1), len(s2)
    h, x, y = _affine_tables(l1, l2)
    for c in range(1, l1 + 1):
        x[0, c] = max(h[0, c - 1] + opn, x[0, c - 1] + ext)
        h[0, c] = x[0, c]
    for r in range(1, l2 + 1):
        y[r, 0] = max(h[r - 1, 0] + opn, y[r - 1, 0] + ext)
        h[r, 0] = y[r, 0]
    for r in range(1, l2 + 1):
        row_sub = sub[s2[r - 1]]
        for c in range(1, l1 + 1):
            x[r, c] = max(h[r, c - 1] + opn, x[r, c - 1] + ext)
            y[r, c] = max(h[r - 1, c] + opn, y[r - 1, c] + ext)
            h[r, c] = max(h[r - 1, c - 1] + row_sub[s1[c - 1]], x[r, c], y[r, c])
    return int(h[l2, l1])


def sw_affine(s1: np.ndarray, s2: np.ndarray, sub: np.ndarray, opn: int, ext: int) -> int:
    """Smith-Waterman local alignment with affine gaps; score floor 0,
    result = max over all cells (>= 0)."""
    l1, l2 = len(s1), len(s2)
    h, x, y = _affine_tables(l1, l2)
    x[0, 0] = y[0, 0] = SCORE_MIN
    best = 0
    for r in range(1, l2 + 1):
        row_sub = sub[s2[r - 1]]
        for c in range(1, l1 + 1):
            x[r, c] = max(h[r, c - 1] + opn, x[r, c - 1] + ext)
            y[r, c] = max(h[r - 1, c] + opn, y[r - 1, c] + ext)
            h[r, c] = max(h[r - 1, c - 1] + row_sub[s1[c - 1]], 0, x[r, c], y[r, c])
            best = max(best, int(h[r, c]))
    return best


def align_score(algo: str, s1, s2, sub, *, gap=0, opn=0, ext=0) -> int:
    s1 = np.asarray(s1)
    s2 = np.asarray(s2)
    if algo == "nw":
        return nw_linear(s1, s2, sub, gap)
    if algo == "ga":
        return ga_affine(s1, s2, sub, opn, ext)
    if algo == "sw":
        return sw_affine(s1, s2, sub, opn, ext)
    raise ValueError(f"unknown algorithm {algo!r}")
