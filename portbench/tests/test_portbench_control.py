"""The control at each cell's own size, on the card: the reference with the
DP cut to a band 8 cells wider than each pair's length difference, put in
the program's place, must fail the comparison on every seed.  It reads the
pairs that a window of the cell's length reads (its first jobs' samples),
scores them with the full and the banded reference, and counts the values
that differ: the control's reading of ``mismatched_scores``.

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -s
"""

import time

import numpy as np
import pytest

from portbench.core import check, spec, traffic
from portbench.reference import matrix
from portbench.tests.conftest import BENCH, ROOT

CELLS = ("swissprot-ga.tiles", "avppred-ga.short", "swissprot-ga.4gpu")
SEEDS = (4101, 2**31 + 4102, 4103)
BAND = 8
#: Jobs whose samples the control reads: about one window's worth of the
#: tile cells' jobs, and every set of the pool.
JOBS = 8


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_size(cuda_card, cell_name):
    bench = spec.Bench(ROOT, BENCH)
    cell = bench.cell(cell_name)
    cfg = cell.config
    _, sub, lut = matrix.load(bench.data(cfg["matrix"], ".txt"))
    gaps = (0, -cfg["gaps"]["open"], -cfg["gaps"]["extend"])
    for seed in SEEDS:
        pool = traffic.make_pool(bench, cell, seed)
        samples = []
        for k in range(JOBS):
            s = check.plan(pool[k % len(pool)], cell.workload["check"], seed,
                           k)
            s.values = np.zeros(len(s.i), np.int64)
            samples.append(s)
        t = time.perf_counter()
        algo = cfg["algorithm"]
        full = check.reference_scores(samples, pool, lut, sub, algo, gaps,
                                      device=cuda_card, budget=1 << 26)
        banded = check.reference_scores(samples, pool, lut, sub, algo, gaps,
                                        device=cuda_card, budget=1 << 26,
                                        band=BAND)
        for s in samples:
            keys, scores = banded[s.set_index]
            s.values = scores[np.searchsorted(
                keys, np.minimum(s.i, s.j) * pool[s.set_index].n
                + np.maximum(s.i, s.j))]
        got = check.compare(samples, pool, full)
        reading = got["numbers"]["mismatched_scores"]
        print(f"control {cell_name} seed {seed}: mismatched_scores "
              f"{reading} of {sum(len(s.i) for s in samples)} values read "
              f"({got['distinct_pairs']} distinct pairs), limit "
              f"{check.LIMITS['mismatched_scores']}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        assert reading > check.LIMITS["mismatched_scores"]
