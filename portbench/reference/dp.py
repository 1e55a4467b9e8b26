"""The benchmark's plain reference: global (NW, Gotoh GA) and local (SW)
alignment scores of many pairs at once, in plain PyTorch.

It imports nothing of the program under test and takes nothing it made:
sequences come as residue codes from the benchmark's own generator and the
substitution matrix from ``reference/matrix.py``.

The recurrences, for row r of the row sequence ``a`` (1-based) and column c
of the column sequence ``b``, with penalties stored negated (<= 0):

    NW  H[r][c] = max(H[r-1][c-1] + S(a_r, b_c), H[r-1][c] + gap,
                      H[r][c-1] + gap);   H[0][c] = c*gap, H[r][0] = r*gap
    GA  X[r][c] = max(H[r][c-1] + open, X[r][c-1] + extend)
        Y[r][c] = max(H[r-1][c] + open, Y[r-1][c] + extend)
        H[r][c] = max(H[r-1][c-1] + S(a_r, b_c), X[r][c], Y[r][c])
        border: X[0][c] = max(H[0][c-1] + open, X[0][c-1] + extend),
        H[0][c] = X[0][c] (and the same down column 0 with Y), H[0][0] = 0,
        X and Y start at minus infinity
    SW  GA's cells with a floor of 0, borders 0; the score is the largest H
        over the pair's cells

NW and GA score H[len a][len b].  One row is computed for every pair of a
batch at once.  Within a row, the horizontal term is a running maximum:
X[r][c] = max over k < c of Z[k] + open + (c-1-k)*max(open, extend), where
Z[k] is the cell's best without X (Z[0] = H[r][0]), so one cumulative
maximum per row replaces the loop over columns.  NW's horizontal term is the
same scan with slope ``gap``.
"""

from __future__ import annotations

import numpy as np
import torch

#: Minus infinity of the recurrences: far below any score, far above int32's
#: floor, so adding penalties never wraps.
NEG = -(1 << 29)

ALGOS = ("nw", "ga", "sw")


def border(algo: str, n: int, gap: int, opn: int, ext: int) -> list:
    """H[0][0..n] (equally H[0..n][0]) by the border recurrence itself."""
    h, x = [0], NEG
    for _ in range(n):
        if algo == "nw":
            h.append(h[-1] + gap)
        elif algo == "ga":
            x = max(h[-1] + opn, x + ext)
            h.append(x)
        else:
            h.append(0)
    return h


def _rows(algo, a, alen, b, blen, sub, gap, opn, ext, band):
    """Scores of P pairs, in order of row length: ``a`` (P, R) row codes
    with lengths ``alen`` (ascending), ``b`` (P, C) column codes with
    lengths ``blen``, all on one device.  At row r only the pairs that have
    a row r are computed: a suffix of the batch.  ``band`` (None for the
    full table) keeps only cells with -band <= c - r <= (blen - alen) +
    band: the control, never a run."""
    dev = a.device
    P, R = a.shape
    C = b.shape[1]
    i32 = torch.int32
    bord = border(algo, max(R, C), gap, opn, ext)
    ks = torch.arange(C + 1, device=dev, dtype=i32)
    ramp = ks * (gap if algo == "nw" else max(opn, ext))
    x_ramp = ramp[:-1] + opn
    # profile[p, s, c]: the score of residue s against b_c of pair p.
    profile = sub[:, b].permute(1, 0, 2).contiguous()
    pidx = torch.arange(P, device=dev)
    h = torch.tensor(bord[: C + 1], dtype=i32, device=dev).expand(
        P, C + 1).contiguous()
    hn = torch.empty_like(h)
    zf = torch.empty_like(h)
    y = torch.full((P, C), NEG, dtype=i32, device=dev)
    out = torch.zeros(P, dtype=i32, device=dev)
    ends = torch.bincount(alen.to(torch.int64), minlength=R + 1).cumsum(0)
    ends = ends.tolist()
    col_ok = ks[1:].unsqueeze(0) <= blen.unsqueeze(1)
    for r in range(1, R + 1):
        s = ends[r - 1]  # pairs [s:] have a row r
        hs, hns, zs, ys = h[s:], hn[s:], zf[s:], y[s:]
        diag = hs[:, :-1] + profile[pidx[s:], a[s:, r - 1]]
        zs[:, 0] = bord[r]
        if algo == "nw":
            torch.maximum(diag, hs[:, 1:] + gap, out=zs[:, 1:])
            body = torch.cummax(zs - ramp, 1).values + ramp
            hns.copy_(body)
        else:
            ys.add_(ext)
            torch.maximum(ys, hs[:, 1:] + opn, out=ys)
            torch.maximum(diag, ys, out=zs[:, 1:])
            if algo == "sw":
                zs[:, 1:].clamp_min_(0)
            x = torch.cummax(zs[:, :-1] - ramp[:-1], 1).values
            torch.add(x, x_ramp, out=hns[:, 1:])
            torch.maximum(hns[:, 1:], zs[:, 1:], out=hns[:, 1:])
            hns[:, 0] = bord[r]
        if band is not None:
            d = ks[1:].unsqueeze(0) - r
            off = (d < -band) | (d > (blen[s:] - alen[s:]).unsqueeze(1) + band)
            hns[:, 1:].masked_fill_(off, NEG)
            if algo != "nw":
                ys.masked_fill_(off, NEG)
        if algo == "sw":
            best = torch.where(col_ok[s:], hns[:, 1:], 0).amax(1)
            torch.maximum(out[s:], best, out=out[s:])
        elif ends[r] > s:
            e = ends[r]
            got = hns[: e - s].gather(1, blen[s:e].to(torch.int64)[:, None])
            out[s:e] = got[:, 0]
        h, hn = hn, h
    return out


def scores(algo: str, codes, offsets, i, j, sub, gaps, *, device="cpu",
           budget=1 << 26, band=None) -> np.ndarray:
    """Scores of the pairs (i[k], j[k]) of the sequences ``codes[offsets[s]
    : offsets[s + 1]]`` (residue codes, one byte each) under the square
    substitution matrix ``sub`` and the negated gaps ``(gap, open,
    extend)``; returns (len(i),) int64.

    Each pair is scored with its shorter sequence as the rows: the scores of
    (a, b) and (b, a) are equal when ``sub`` is symmetric, which is checked.
    Pairs go in batches of one class of column widths, in order of row
    length, each holding at most ``budget`` cells of one row sweep."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}")
    sub = np.asarray(sub, np.int64)
    if not np.array_equal(sub, sub.T):
        raise ValueError("the reference scores pairs either way round: the "
                         "substitution matrix must be symmetric")
    if sub.shape[0] > 256:
        raise ValueError("residue codes must fit a byte")
    gap, opn, ext = (int(g) for g in gaps)
    if max(gap, opn, ext) > 0:
        raise ValueError("penalties are stored negated (<= 0)")
    codes = np.asarray(codes, np.uint8)
    offsets = np.asarray(offsets, np.int64)
    lens = np.diff(offsets)
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    if len(i) and (lens[i].min() == 0 or lens[j].min() == 0):
        raise ValueError("empty sequence")
    with torch.inference_mode():
        return _batches(algo, codes, offsets, lens, i, j, sub, gap, opn, ext,
                        device, budget, band)


def _padded(codes, offsets, seqs, lengths, width):
    """(len(seqs), width) uint8 codes of ``seqs``, 0 past each length."""
    t = np.arange(width)
    idx = np.minimum(offsets[seqs][:, None] + t, len(codes) - 1)
    return np.where(t < lengths[:, None], codes[idx], 0).astype(np.uint8)


def _batches(algo, codes, offsets, lens, i, j, sub, gap, opn, ext, device,
             budget, band):
    sub_t = torch.as_tensor(sub, dtype=torch.int32, device=device)
    short = lens[i] <= lens[j]
    rows, cols = np.where(short, i, j), np.where(short, j, i)
    rl, cl = lens[rows], lens[cols]
    out = np.zeros(len(i), np.int64)
    # A batch holds pairs of one class of column widths (within a factor of
    # two), in order of row length.
    width = np.ceil(np.log2(np.maximum(cl, 1))).astype(np.int64)
    order = np.lexsort((cl, rl, width))
    starts = np.flatnonzero(np.diff(width[order], prepend=-1))
    for k0, k1 in zip(starts, np.r_[starts[1:], len(order)]):
        cls = order[k0:k1]
        per = max(1, budget // (int(cl[cls].max()) + 1))
        for b0 in range(0, len(cls), per):
            idx = cls[b0: b0 + per]
            rmax, cmax = int(rl[idx].max()), int(cl[idx].max())
            a = _padded(codes, offsets, rows[idx], rl[idx], rmax)
            b = _padded(codes, offsets, cols[idx], cl[idx], cmax)
            got = _rows(
                algo, torch.as_tensor(a, device=device).long(),
                torch.as_tensor(rl[idx], dtype=torch.int32, device=device),
                torch.as_tensor(b, device=device).long(),
                torch.as_tensor(cl[idx], dtype=torch.int32, device=device),
                sub_t, gap, opn, ext, band)
            out[idx] = got.cpu().numpy()
    return out
