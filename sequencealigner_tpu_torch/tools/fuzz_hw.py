"""On-card fuzz of the superblock entry points against the plain versions.

    SEED=11 TRIALS=8 python -m sequencealigner_tpu_torch.tools.fuzz_hw

Each trial draws, as the reference's ``benchmarks/fuzz_hw.py`` does, a
matrix (BLOSUM62, PAM250, BLOSUM30 or NUC44), an algorithm (NW, GA, SW),
random gaps, Lc in 2-519, Lk <= Lc and 256 pairs of random lengths; runs
``superblock.align_superblock`` in grid mode and in inline mode on the card;
and requires both to equal the kernels' plain versions on the same inputs
on the card, and the two plain versions each other, exactly.  Prints
``HW FUZZ PASS`` at the end.  Without a CUDA device it exits 2: it never
runs on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import engine, matrices
from ..ops import geometry, superblock, torch_dp

MATRICES = ["blosum62", "pam250", "blosum30", "nuc44"]


def run(seed: int, trials: int, log=print) -> None:
    """The fuzz on the current CUDA device; raises AssertionError on the
    first mismatch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    for t in range(trials):
        mname = MATRICES[rng.integers(0, len(MATRICES))]
        M = matrices.get(mname)
        nlet = 16 if mname == "nuc44" else 20
        algo = ["nw", "ga", "sw"][rng.integers(0, 3)]
        if algo == "nw":
            gaps = (-int(rng.integers(1, 13)), 0, 0)
        else:
            gaps = (0, -int(rng.integers(1, 15)), -int(rng.integers(1, 15)))
        Lc = int(rng.integers(2, 520))
        Lk = int(rng.integers(1, Lc + 1))
        n = 256
        l1 = rng.integers(1, Lc + 1, n).astype(np.int32)
        l2 = rng.integers(1, Lk + 1, n).astype(np.int32)
        s1 = np.full((n, Lc), geometry.PAD, np.int8)
        s2 = np.full((n, Lk), geometry.PAD, np.int8)
        for b in range(n):
            s1[b, : l1[b]] = rng.integers(0, nlet, l1[b])
            s2[b, : l2[b]] = rng.integers(0, nlet, l2[b])
        sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
        s1, s2, l1, l2 = (torch.from_numpy(a).to(dev) for a in (s1, s2, l1, l2))
        kw = dict(algo=algo, Lc=Lc, Lk=Lk, B=geometry.LANE)
        grid = superblock.align_superblock(s1, s2, l1, l2, sub, g, **kw)
        inline = superblock.align_superblock(s1, s2, l1, l2, sub, g,
                                             inline=True, **kw)
        nb, Kpad, CD, W = geometry.geometry(Lc, Lk, geometry.LANE)
        sk = superblock.build_stream(s1, s2, sub, S=n // geometry.LANE,
                                     B=geometry.LANE, Lc=Lc, Lk=Lk,
                                     Kpad=Kpad, W=W)
        want = torch_dp.align_grid_plain(sk, l1, l2, g, algo=algo)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        want_inline = torch_dp.align_pairs_plain(s1, s2, rows, rows, l1, l2,
                                                 sub, g, algo=algo)
        ok = (torch.equal(grid, want) and torch.equal(inline, want_inline)
              and torch.equal(want, want_inline))
        log(f"[{t}] {algo} {mname} gaps={gaps} Lc={Lc} Lk={Lk}: "
            f"{'OK' if ok else 'MISMATCH!!'}")
        if not ok:
            raise AssertionError(f"fuzz trial {t} mismatch")
    log("HW FUZZ PASS")


def main() -> int:
    if not torch.cuda.is_available():
        print("fuzz_hw: no CUDA device", file=sys.stderr)
        return 2
    run(int(os.environ.get("SEED", 0)), int(os.environ.get("TRIALS", 8)),
        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
