"""Kernel-rate harness of the superblock entry point, on the card.

    python -m sequencealigner_tpu_torch.tools.profile_kernels \\
        ga,64,64,128,8,check nw,256,256,128,256,inline ...

Each argument is ``algo,Lc,Lk,B,S[,check][,inline]``: S*B pairs of full
length (Lc columns, Lk rows, random BLOSUM62 residues), GA/SW gaps 10/1
and NW gap 4.  Prints CUDA-event milliseconds per call of ``build_stream``
(grid mode only), of the kernel alone and of the whole
``align_superblock`` call, then true GCUPS (S*B*Lc*Lk cells over the whole
call) and padded Gcell/s (S*B*Kpad*W cells over the kernel).  ``check``
compares the result with the kernel's plain version on the card.  Without
a CUDA device it exits 2: it never runs on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import engine, matrices
from ..ops import cuda_dp, geometry, superblock, torch_dp

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


def rate(algo: str, Lc: int, Lk: int, B: int, S: int, *, check=False,
         inline=False, seed: int = 0) -> str:
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = S * B
    s1 = torch.from_numpy(rng.integers(0, 20, (n, Lc)).astype(np.int8)).to(dev)
    s2 = torch.from_numpy(rng.integers(0, 20, (n, Lk)).astype(np.int8)).to(dev)
    l1 = torch.full((n,), Lc, dtype=torch.int32, device=dev)
    l2 = torch.full((n,), Lk, dtype=torch.int32, device=dev)
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
    line = (f"{algo}{' inline' if inline else ''} Lc={Lc} Lk={Lk} B={B} "
            f"S={S}: build {build:.4f} ms, kernel {kern:.4f} ms, call "
            f"{whole:.4f} ms -> true {n * Lc * Lk / whole / 1e6:.1f} GCUPS, "
            f"padded kernel {n * Kpad * W / kern / 1e6:.1f} Gcell/s")
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
                   check="check" in opts, inline="inline" in opts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
