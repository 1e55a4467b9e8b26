"""Superblock entry points: S*B arbitrary pairs scored in one call.

The counterpart of ``sequencealigner_tpu/ops/pallas_dp.py``'s
``build_stream`` and ``align_superblock``, the kernel-level entry points of
the reference's per-pair mode (its tests, ``tools/fuzz_hw`` and
``tools/profile_kernels`` call them; the engine does not).

- Grid mode (``inline=False``, the default): ``build_stream`` writes the
  int8 (S, W, Kpad, B) substitution grid with torch ops (the reference
  builds it in plain XLA, outside Pallas), then the grid kernel
  ``cuda_dp.align_grid`` sweeps it.
- Inline mode (``inline=True``): the per-pair kernel ``cuda_dp.align_pairs``
  scores straight from the int8 code rows (pair n aligns row n of s1 with
  row n of s2).  That kernel reads code matrices directly, so the
  reference's byte packing for its in-kernel lookup (``build_inline``) has
  no counterpart here.

Tensors on the CPU run the kernels' plain versions; CUDA tensors launch the
kernels.
"""

from __future__ import annotations

import torch

from . import cuda_dp
from .geometry import PAD, PAD_MARK, geometry

#: Largest int64 index tensor build_stream materialises at once (elements);
#: bigger grids are built in slices of superblock rows.
GATHER_ELEMS = 1 << 27


def build_stream(s1, s2, sub_p, *, S: int, B: int, Lc: int, Lk: int,
                 Kpad: int, W: int):
    """(S, W, Kpad, B) int8 substitution grid: out[s, w, k, b] =
    sub[s2[n, k], s1[n, w]] (n = s*B + b), PAD_MARK at pad rows/columns.

    s1 (S*B, Lc) / s2 (S*B, Lk) letter codes (PAD beyond each length);
    sub_p the (25, 25) padded substitution matrix, whose [:24, :24] frame
    is cast to int8 as the reference does.  One gather of a (25, 25) int8
    table that holds PAD_MARK outside that frame."""
    dev = s1.device
    subm = torch.full((PAD + 1, PAD + 1), PAD_MARK, dtype=torch.int8,
                      device=dev)
    subm[:24, :24] = sub_p[:24, :24].to(torch.int8)
    subm = subm.reshape(-1)
    s1p = torch.full((S * B, W), PAD, dtype=torch.int64, device=dev)
    s1p[:, :Lc] = s1
    s2p = torch.full((S * B, Kpad), PAD, dtype=torch.int64, device=dev)
    s2p[:, :Lk] = s2
    # [s][w][k][b] layout: columns (w) and rows (k) of B pairs, lanes minor.
    cols = s1p.reshape(S, B, W).permute(0, 2, 1)  # (S, W, B)
    rows = s2p.reshape(S, B, Kpad).permute(0, 2, 1) * (PAD + 1)  # (S, K, B)
    out = torch.empty((S, W, Kpad, B), dtype=torch.int8, device=dev)
    step = max(1, GATHER_ELEMS // (W * Kpad * B))
    for s0 in range(0, S, step):
        sl = slice(s0, s0 + step)
        out[sl] = subm[rows[sl, None, :, :] + cols[sl, :, None, :]]
    return out


def align_superblock(s1, s2, l1, l2, sub_p, gaps, *, algo: str, Lc: int,
                     Lk: int, B: int, inline: bool = False):
    """Scores of S*B pairs, pair n = (s1[n], s2[n]) -> (S*B,) int32.

    s1 (S*B, Lc) / s2 (S*B, Lk) letter codes (PAD beyond l1 / l2), Lk <= Lc;
    l1, l2 (S*B,) int32 true lengths; sub_p the (25, 25) int32 padded
    matrix; gaps the (3,) int32 [gap, open, extend] (negated).  Grid mode
    needs |score| <= 127 (the grid is int8), as in the reference."""
    n = s1.shape[0]
    if n % B:
        raise ValueError(f"{n} pairs are not a whole number of {B}-lane rows")
    if tuple(s1.shape) != (n, Lc) or tuple(s2.shape) != (n, Lk):
        raise ValueError("s1 / s2 must be (S*B, Lc) / (S*B, Lk)")
    l1 = l1.to(torch.int32).contiguous()
    l2 = l2.to(torch.int32).contiguous()
    if inline:
        rows = torch.arange(n, dtype=torch.int32, device=s1.device)
        return cuda_dp.align_pairs(
            s1.to(torch.int8).contiguous(), s2.to(torch.int8).contiguous(),
            rows, rows, l1, l2, sub_p, gaps, algo=algo,
        )
    nb, Kpad, CD, W = geometry(Lc, Lk, B)
    sk = build_stream(s1, s2, sub_p, S=n // B, B=B, Lc=Lc, Lk=Lk, Kpad=Kpad,
                      W=W)
    return cuda_dp.align_grid(sk, l1, l2, gaps, algo=algo)
