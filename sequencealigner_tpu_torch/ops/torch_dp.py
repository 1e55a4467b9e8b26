"""Plain PyTorch versions of the two DP kernels (csrc/align_dp.cu).

Each function has exactly the contract of its kernel's wrapper in
ops/cuda_dp.py; the wrappers call them for tensors on the CPU, the CPU tests
run them, and chip_smoke.py holds the kernels against them on the card.

Both score pairs by one column sweep over all pairs at once.  For column c
(1-based) and DP rows r = 1..K:

    diag[r] = H[r-1][c-1] + sub[s2[r-1]][s1[c-1]]
    x[r]    = max(H[r][c-1] + opn, X[r][c-1] + ext)
    z[r]    = max(diag[r], x[r])
    y[r]    = max(y[r-1] + max(ext, opn), z[r-1] + opn)
    H[r][c] = max(z[r], y[r])                    (and >= 0 for SW)

The first-order y recurrence is solved as a cumulative max in the
y - r*slope domain (torch.cummax); NW's vertical term is the same scan with
slope = gap.  (For SW the reopen term from the 0 floor is dropped: it never
wins, since an optimal local alignment never opens a gap from a zero cell.)
Borders follow the reference: GA's border slope is max(opn, ext), because
the reference reads H = X at every border cell.  NW/GA return H[l2][l1];
SW the maximum over the valid cells; a pair with a zero length scores 0.
"""

from __future__ import annotations

import torch

from ..matrices import SCORE_MIN
from .geometry import LANE, PAD, S_TILE

ALGOS = ("nw", "ga", "sw")


def _border(algo: str, k: torch.Tensor, gap: int, opn: int, slope: int):
    """H at left/top border index k (k = 0 is the corner, 0)."""
    if algo == "nw":
        return k * gap
    if algo == "ga":
        return torch.where(k == 0, 0, opn + (k - 1) * slope)
    return torch.zeros_like(k)


def score_pairs(ccodes, l1, kcodes, l2, sub, gaps, *, algo: str):
    """Scores of P pairs: column codes ccodes (P, Wc), row codes kcodes
    (P, K), true lengths l1, l2 (P,), sub the (25, 25) int32 padded
    substitution matrix, gaps the (3,) int32 [gap, open, extend] (negated).
    Returns (P,) int32."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}")
    dev = kcodes.device
    P, K = kcodes.shape
    out = torch.zeros(P, dtype=torch.int32, device=dev)
    l1 = l1.to(torch.int64)
    l2 = l2.to(torch.int64)
    act = torch.nonzero((l1 > 0) & (l2 > 0)).squeeze(1)
    if act.numel() == 0:
        return out
    ncol = int(l1[act].max())
    cc = ccodes[act, :ncol].to(torch.int64)
    kc = kcodes[act].to(torch.int64) * (PAD + 1)  # row offsets into sub
    l1, l2 = l1[act], l2[act]
    gap, opn, ext = (int(g) for g in gaps.tolist())
    slope = gap if algo == "nw" else max(opn, ext)
    subf = sub.reshape(-1).to(torch.int32)
    i32 = torch.int32
    rows = torch.arange(K + 1, device=dev, dtype=i32)
    ramp = rows * slope
    n = act.numel()
    H = _border(algo, rows, gap, opn, slope).to(i32).expand(n, K + 1).clone()
    X = torch.full((n, K), SCORE_MIN, dtype=i32, device=dev)
    valid_row = rows[1:].unsqueeze(0) <= l2.unsqueeze(1)  # (n, K), SW only
    res = torch.zeros(n, dtype=i32, device=dev)
    for c in range(1, ncol + 1):
        h0 = int(_border(algo, torch.tensor(c), gap, opn, slope))
        col = torch.full((n, 1), h0, dtype=i32, device=dev)
        diag = H[:, :-1] + subf[kc + cc[:, c - 1 : c]]
        if algo == "nw":
            z = torch.cat([col, torch.maximum(diag, H[:, 1:] + gap)], 1)
            H = torch.cummax(z - ramp, 1).values + ramp
        else:
            x = torch.maximum(H[:, 1:] + opn, X + ext)
            z = torch.maximum(diag, x)
            top = torch.full((n, 1), max(SCORE_MIN + ext, h0 + opn),
                             dtype=i32, device=dev)
            zs = torch.cat([top, z[:, :-1] + opn], 1)
            y = torch.cummax(zs - ramp[1:], 1).values + ramp[1:]
            h = torch.maximum(z, y)
            if algo == "sw":
                h = torch.clamp_min(h, 0)
                best = torch.where(valid_row, h, 0).amax(1)
                res = torch.where(c <= l1, torch.maximum(res, best), res)
            H = torch.cat([col, h], 1)
            X = x
        if algo != "sw":
            at = H.gather(1, l2.unsqueeze(1)).squeeze(1)
            res = torch.where(l1 == c, at, res)
    out[act] = res
    return out


def align_tiles_plain(desc, cwords, kmatT, klens, sub, gaps, *, algo: str):
    """Plain version of the tile kernel (reference: pallas_dp.align_outer).

    desc (T, 2) int32 [c0_row, k_tile]; cwords, kmatT, klens the
    geometry.pack_bucket_outer arrays of the c and k buckets.  Tile t pairs
    c-rows desc[t,0] + s (s < S_TILE) with k-lanes desc[t,1]*LANE + b.
    Returns (T, S_TILE, LANE) int32 scores."""
    dev = desc.device
    T = desc.shape[0]
    desc = desc.to(torch.int64)
    ar = torch.arange(S_TILE, device=dev)
    crow = desc[:, :1] + ar  # (T, S_TILE)
    klane = desc[:, 1:] * LANE + torch.arange(LANE, device=dev)  # (T, LANE)
    cbytes = cwords.contiguous().view(torch.uint8)[:, 4:]  # (rows, W) codes
    t, s, b = torch.meshgrid(
        torch.arange(T, device=dev), ar, torch.arange(LANE, device=dev),
        indexing="ij",
    )
    cr = crow[t, s].reshape(-1)
    kl = klane[t, b].reshape(-1)
    l1, l2 = cwords[cr, 0], klens[0, kl]
    # Gather codes only for pairs that score (dummy rows and pad lanes are 0).
    act = torch.nonzero((l1 > 0) & (l2 > 0)).squeeze(1)
    out = torch.zeros(T * S_TILE * LANE, dtype=torch.int32, device=dev)
    cr, kl = cr[act], kl[act]
    out[act] = score_pairs(
        cbytes[cr], l1[act], kmatT[:, kl].T, l2[act], sub, gaps, algo=algo
    )
    return out.reshape(T, S_TILE, LANE)


def align_pairs_plain(mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, *,
                      algo: str):
    """Plain version of the per-pair kernel (reference:
    pallas_dp.align_prebuilt_inline via align_packed).

    mat_c (count_c, Lc) / mat_k (count_k, Lk) int8 bucket code matrices
    (PAD beyond each length), rc / rk (P,) int32 row indices into them,
    lens_c / lens_k the buckets' int32 true lengths.  Pair p aligns row
    rc[p] of mat_c (columns) with row rk[p] of mat_k (rows).  Returns (P,)
    int32 scores."""
    rc = rc.to(torch.int64)
    rk = rk.to(torch.int64)
    return score_pairs(
        mat_c[rc], lens_c[rc], mat_k[rk], lens_k[rk], sub, gaps, algo=algo
    )
