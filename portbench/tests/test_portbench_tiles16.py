"""The reader of the tile kernel's 16-bit share
(metrics/kernel.tiles_s16_share.py) on hand-made runs of the program's
recorder: it reads the cell-weighted share of align_tiles' cells that ran
at 16 bits, and nothing where the counts are missing, disagree with the
harness's cells, hold no align_tiles launch, or come from a program whose
launches carry no ``bits`` (the parent of the change that brought them)."""

import collections

import pytest

from portbench.core import harness, spec
from portbench.tests.conftest import BENCH, ROOT
from sequencealigner_tpu_torch import trace

NAME = "kernel.tiles_s16_share"
#: A launch count of a program before the ``bits`` field.
OldLaunch = collections.namedtuple(
    "OldLaunch", ("kernel", "pairs", "cells", "lanes", "waves"))


def _reader():
    return spec.Bench(ROOT, BENCH).module("metrics", NAME)


def _run(t0: float, launches):
    """A recorded run of 1 s from ``t0`` holding ``launches``."""
    run = trace.Run()
    run.top = trace.Span(trace.TOP, t0, "main", 1, None, run.id)
    run.top.t1 = t0 + 1.0
    run.spans.append(run.top)
    run.dp_launches = list(launches)
    return run


def _readings(monkeypatch, jobs):
    """Readings of one job a second from t = 10 s, each job's launches
    recorded by one run; each job's cells are its launches' own."""
    runs = [_run(10.0 + k, ls) for k, ls in enumerate(jobs)]
    monkeypatch.setattr(trace, "_runs",
                        collections.deque(runs, maxlen=trace.KEEP))
    return harness.Readings(
        "ga", [harness.Job(k, 0, 9.95 + k, 11.05 + k, c, c, {}, {}, {}, {})
               for k, c in enumerate(sum(x.cells for x in ls)
                                     for ls in jobs)], [0], None)


TILES16 = trace.Launch("align_tiles", 4096, 6_000_000, 1, 12.5, 16)
TILES32 = trace.Launch("align_tiles", 4096, 2_000_000, 1, 3.0, 32)
PAIRS = trace.Launch("align_pairs", 2016, 1_000_000, 4, 0.25)


def test_share_is_cell_weighted_over_tile_launches(monkeypatch):
    """align_pairs' cells count for nothing; the tile launches' cells
    weigh each form."""
    r = _readings(monkeypatch, [[TILES16, PAIRS], [TILES32, TILES16]])
    assert _reader().read(r) == pytest.approx(12 / 14)
    r = _readings(monkeypatch, [[TILES16, PAIRS]])
    assert _reader().read(r) == 1.0
    r = _readings(monkeypatch, [[TILES32, PAIRS]])
    assert _reader().read(r) == 0.0


@pytest.mark.parametrize("jobs", [
    [[PAIRS]],
    [[OldLaunch("align_tiles", 4096, 6_000_000, 1, 12.5), PAIRS]],
    [],
], ids=["no-tile-launch", "no-bits", "no-jobs"])
def test_reads_nothing_without_what_it_counts(monkeypatch, jobs):
    assert _reader().read(_readings(monkeypatch, jobs)) is None


def test_reads_nothing_when_cells_disagree(monkeypatch):
    r = _readings(monkeypatch, [[TILES16, PAIRS]])
    r.jobs[0].cells += 1
    assert _reader().read(r) is None
