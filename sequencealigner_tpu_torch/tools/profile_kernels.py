"""Kernel-rate harness of the superblock entry point, on the card.

    python -m sequencealigner_tpu_torch.tools.profile_kernels \\
        ga,64,64,128,8,check nw,256,256,128,256,inline ...

Each argument is ``algo,Lc,Lk,B,S[,check][,inline][,random]``: S*B pairs
of full length (Lc columns, Lk rows, random BLOSUM62 residues), or with
``random`` of lengths uniform in 1..Lc and 1..Lk (as chip_smoke.py (e)
draws them), GA/SW gaps 10/1 and NW gap 4.  Prints CUDA-event
milliseconds per call of ``build_stream`` (grid mode only), of the kernel
alone and of the whole ``align_superblock`` call, then true GCUPS (cells
over the whole call) and padded Gcell/s (S*B*Kpad*W cells over the
kernel); in grid mode also the launch's copy form, ring stages and
resident blocks per SM, and the kernel's share of its bound (``grid_bound``:
the bytes the pairs' lengths need, or the cells' arithmetic where that is
longer) and of the whole grid's bytes.  ``check`` compares the result with
the kernel's plain version on the card.  Without a CUDA device it exits 2:
it never runs on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import engine, matrices
from ..ops import cuda_dp, geometry, superblock, torch_dp
from ..ops.geometry import LANE

GAPS = {"nw": (-4, 0, 0), "ga": (0, -10, -1), "sw": (0, -10, -1)}


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call on the card, after one warm-up call
    (CUDA events around ``reps`` calls; chip_smoke.py times with it too)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def grid_traffic(l1, l2, S: int, W: int, Kpad: int, B: int) -> dict:
    """Bytes of an (S, W, Kpad, B) int8 grid, for pairs of lengths l1, l2
    (numpy, S*B each, clamped to the grid): ``grid``, all of it;
    ``needed``, the cells some pair's lengths reach, in 32-lane groups (a
    group's byte of each cell is one 32-byte sector of the device where B
    is a multiple of 32): per superblock row and group, the union of its
    pairs' l1 x l2 rectangles times the group's lanes;
    ``copied``, what the grid kernel copies: per item (a row's 128-lane
    chunk) and band, the columns up to the block's longest l1 in the
    column groups that some pair reaching that band reaches (a stage no
    pair reaches is not copied)."""
    from ..ops.cuda_dp import KB

    a = np.clip(np.asarray(l1, np.int64), 0, W).reshape(S, B)
    b = np.clip(np.asarray(l2, np.int64), 0, Kpad).reshape(S, B)
    live = (a > 0) & (b > 0)
    a, b = np.where(live, a, 0), np.where(live, b, 0)
    pad = -B % 32
    ga = np.pad(a, ((0, 0), (0, pad))).reshape(S, -1, 32)
    gb = np.pad(b, ((0, 0), (0, pad))).reshape(S, -1, 32)
    order = np.argsort(-ga, axis=2, kind="stable")
    sa = np.take_along_axis(ga, order, 2)
    sb = np.maximum.accumulate(np.take_along_axis(gb, order, 2), axis=2)
    step = sa - np.concatenate([sa[:, :, 1:], np.zeros_like(sa[:, :, :1])],
                               axis=2)
    gwidth = np.minimum(32, B - 32 * np.arange(ga.shape[1]))
    needed = int(((step * sb).sum(axis=(0, 2)) * gwidth).sum())
    copied = 0
    for c0 in range(0, B, LANE):
        width = min(LANE, B - c0)
        ca, cb = a[:, c0:c0 + width], b[:, c0:c0 + width]
        L1 = ca.max(axis=1)
        bands = -(-cb // KB)
        groups = -(-ca // 4)
        for k in range(-(-Kpad // KB)):
            reach = np.where(bands > k, groups, 0).max(axis=1)
            rows = min(KB, Kpad - k * KB)
            copied += int(np.minimum(4 * reach, L1).sum()) * rows * width
    return {"grid": S * W * Kpad * B, "needed": needed, "copied": copied}


def grid_bound(l1, l2, S: int, W: int, Kpad: int, B: int,
               algo: str) -> tuple:
    """(ms, what bounds it, grid_traffic) of one align_grid call on an H100
    for pairs of lengths l1, l2 (numpy, S*B each): the larger of its true
    cells' operations (tools/profile_main.bound_ms) and the bytes it must
    move at 3.35 TB/s: the grid's sectors that the lengths need
    (``needed``), the lengths and gaps read and the int32 scores
    written."""
    from .profile_main import bound_ms

    traffic = grid_traffic(l1, l2, S, W, Kpad, B)
    a = np.clip(np.asarray(l1, np.int64), 0, W)
    b = np.clip(np.asarray(l2, np.int64), 0, Kpad)
    ops = bound_ms(int((a * b).sum()), algo)
    mem = (traffic["needed"] + 3 * 4 * S * B + 12) / 3.35e12 * 1e3
    return ((ops, "operations") if ops >= mem else (mem, "bytes")) + (traffic,)


def rate(algo: str, Lc: int, Lk: int, B: int, S: int, *, check=False,
         inline=False, random=False, seed: int = 0) -> str:
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = S * B
    s1 = torch.from_numpy(rng.integers(0, 20, (n, Lc)).astype(np.int8)).to(dev)
    s2 = torch.from_numpy(rng.integers(0, 20, (n, Lk)).astype(np.int8)).to(dev)
    l1, l2 = (torch.from_numpy(rng.integers(1, L + 1, n).astype(np.int32))
              .to(dev) if random else
              torch.full((n,), L, dtype=torch.int32, device=dev)
              for L in (Lc, Lk))
    cells = int((l1.long() * l2.long()).sum())
    sub, g = engine.from_reference_inputs(
        matrices.get("blosum62").matrix, GAPS[algo], dev)
    nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
    kw = dict(algo=algo, Lc=Lc, Lk=Lk, B=B, inline=inline)
    whole = cuda_ms(lambda: superblock.align_superblock(
        s1, s2, l1, l2, sub, g, **kw))
    if inline:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        args = (s1, s2, rows, rows, l1, l2, sub, g)
        kern_fn, plain_fn = cuda_dp.align_pairs, torch_dp.align_pairs_plain
        build = 0.0
    else:
        sk = superblock.build_stream(s1, s2, sub, S=S, B=B, Lc=Lc, Lk=Lk,
                                     Kpad=Kpad, W=W)
        args = (sk, l1, l2, g)
        kern_fn, plain_fn = cuda_dp.align_grid, torch_dp.align_grid_plain
        build = cuda_ms(lambda: superblock.build_stream(
            s1, s2, sub, S=S, B=B, Lc=Lc, Lk=Lk, Kpad=Kpad, W=W))
    kern = cuda_ms(lambda: kern_fn(*args, algo=algo))
    line = (f"{algo}{' inline' if inline else ''}"
            f"{' random' if random else ''} Lc={Lc} Lk={Lk} B={B} "
            f"S={S}: build {build:.4f} ms, kernel {kern:.4f} ms, call "
            f"{whole:.4f} ms -> true {cells / whole / 1e6:.1f} GCUPS, "
            f"padded kernel {n * Kpad * W / kern / 1e6:.1f} Gcell/s")
    if not inline:
        lay = cuda_dp.grid_launch_layout(sk, algo)
        b, by, traffic = grid_bound(l1.cpu().numpy(), l2.cpu().numpy(), S,
                                    W, Kpad, B, algo)
        whole_b = traffic["grid"] / 3.35e12 * 1e3
        line += (f"; form {lay['form']} ({lay['unit']} B units), "
                 f"{lay['stages']} stages, {cuda_dp.grid_resident(algo)} "
                 f"resident blocks per SM; bound {b:.4f} ms ({by}, "
                 f"{traffic['needed']} bytes needed), share {b / kern:.3f}; "
                 f"whole grid {whole_b:.4f} ms, share {whole_b / kern:.3f}")
    if check:
        ok = torch.equal(kern_fn(*args, algo=algo), plain_fn(*args, algo=algo))
        line += f"  check: {'OK' if ok else 'MISMATCH!!'}"
        if not ok:
            raise AssertionError(line)
    return line


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    for arg in argv:
        algo, Lc, Lk, B, S, *opts = arg.split(",")
        print(rate(algo, int(Lc), int(Lk), int(B), int(S),
                   check="check" in opts, inline="inline" in opts,
                   random="random" in opts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
