"""Issue rate of the DP sweep's integer instructions on the card.

    python -m sequencealigner_tpu_torch.tools.dpx_rate [--iters 20000]
        [--repeats 3]

Builds tools/dpx_rate.cu with nvcc (into the port's build cache) and runs
each of its kernels at full occupancy: one instruction kind alone (int32
add, ``__viaddmax_s32``, ``__vimax3_s32`` and their 16x2 forms) and one
NW / GA / SW cell's arithmetic (two cells a step in the 16x2 kinds), with independent chains per thread so that throughput, not
latency, is timed.  Each block records its SM and that SM's clocks
(clock64), and an SM's rate is its blocks' work over the clocks from its
first block's start to its last block's end, so the rates are per SM
clock and do not depend on the clock the card ran at.  Prints,
per kind and repeat, operations (or cells) per clock per SM, then the SASS
opcodes that ptxas emitted for each kernel (``cuobjdump -sass``), which say
on what the rates were taken.  The cell rates are the denominators of
tools/profile_main.bound_ms.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .. import buildcache
from ..ops import cuda_dp

SRC = Path(__file__).resolve().with_name("dpx_rate.cu")
CHAINS = 8  # dpx_rate.cu CHAINS
THREADS = 256
#: (kind, what one chain's step does, its operations, unit of the rate).
KINDS = [
    ("iadd", "a = a + b", 1, "ops"),
    ("addmax", "__viaddmax_s32", 1, "ops"),
    ("max3", "__vimax3_s32", 2, "ops"),
    ("nw", "NW cell: 1 add, 2 viaddmax", 1, "cells"),
    ("ga", "GA cell: 3 add, 2 viaddmax, 1 vimax3", 1, "cells"),
    ("sw", "SW cell: GA's with vimax3_relu, 1 max", 1, "cells"),
    ("add2", "__vadd2", 2, "ops"),
    ("addmax2", "__viaddmax_s16x2", 2, "ops"),
    ("max3_2", "__vimax3_s16x2", 4, "ops"),
    ("nw2", "two NW cells in 16x2", 2, "cells"),
    ("ga2", "two GA cells in 16x2", 2, "cells"),
    ("sw2", "two SW cells in 16x2", 2, "cells"),
    ("ga2s", "two GA cells in 16x2, shifted domain", 2, "cells"),
]
OPCODES = ("IADD3", "IMAD", "VIADDMNMX", "VIMNMX3", "VIMNMX", "IMNMX", "LOP3",
           "MOV", "PRMT", "LEA", "VIADD", "VADD", "HADD2", "SHF", "SEL")


def build() -> ctypes.CDLL:
    """nvcc the microbenchmark once per source hash; returns the library."""
    so = buildcache.library_path("dpx_rate", cuda_dp.ARCH.encode(),
                                 SRC.read_bytes())
    buildcache.build(so, cuda_dp.nvcc_command([SRC]))
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpx_rate_run.argtypes = [i, i, i, p, p, p]
    lib.dpx_rate_run.restype = i
    lib.dpx_rate_error_string.argtypes = [i]
    lib.dpx_rate_error_string.restype = ctypes.c_char_p
    lib.path = so
    return lib


def measure(lib, kind: int, iters: int) -> tuple:
    """(rate per SM clock: mean, least and most over the SMs; resident
    blocks per SM) of one run of ``kind``.  An SM's rate is the work of its
    blocks over the clocks from its first block's start to its last
    block's end."""
    cyc = (ctypes.c_double * 3)()
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.dpx_rate_run(kind, iters, THREADS, cyc, ctypes.byref(per_sm),
                           ctypes.byref(sms))
    if err:
        raise RuntimeError(lib.dpx_rate_error_string(err).decode())
    block = iters * CHAINS * KINDS[kind][2] * THREADS
    return block / cyc[0], block / cyc[2], block / cyc[1], per_sm.value


def sass_opcodes(so: Path) -> dict:
    """Per kernel kind, the count of each opcode (with its modifiers, e.g.
    IMAD.IADD) whose base is in OPCODES, in its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*rate_kernelILi(\d+)E", ln)
        if m:
            cur = out.setdefault(KINDS[int(m.group(1))][0],
                                 collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if cur is not None and m and m.group(1).split(".")[0] in OPCODES:
            cur[m.group(1)] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dpx_rate: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    print(f"dpx_rate on {torch.cuda.get_device_name(0)}: {THREADS} threads "
          f"a block, {CHAINS} chains a thread, {args.iters} steps")
    for k, (name, what, ops, unit) in enumerate(KINDS):
        for rep in range(args.repeats):
            r, lo, hi, per_sm = measure(lib, k, args.iters)
            print(f"dpx_rate {name:6s} ({what}): {r:.3f} {unit}/clock/SM "
                  f"(SMs {lo:.3f}-{hi:.3f}), {per_sm} blocks/SM "
                  f"(repeat {rep})")
    for name, ops in sass_opcodes(lib.path).items():
        print(f"dpx_rate sass {name}: " + ", ".join(
            f"{op} {n}" for op, n in sorted(ops.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
