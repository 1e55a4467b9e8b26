"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Exits 2 without a result when there is no
CUDA device or fewer than the cell's cards; the last line of standard
output is the result's JSON object.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _caches() -> None:
    """The program's kernel build cache (its only one) at a fixed path
    inside the checkout, so that only a checkout's first run builds."""
    os.environ["SEQALIGN_TPU_CACHE"] = str(HERE / ".cache" / "kernels")


if __name__ == "__main__":
    _caches()
    # The checkout's root, not this folder, heads the import path.
    sys.path[0] = str(ROOT)
    from portbench.core import harness

    sys.exit(harness.main(sys.argv[1:], root=ROOT, t_start=T_START))
