"""The reader of the flusher's direct scatter (metrics/engine.direct_share.py)
on hand-made runs of the program's recorder and on a traced run of a small
cell on the CPU, and the comparison that decides ``correct`` against a
direct scatter that leaves pairs out."""

import collections
import sys

import pytest

from portbench.core import harness, spec
from portbench.tests.conftest import BENCH, ROOT, run_cpu, tiny_bench
from sequencealigner_tpu_torch import trace

NAME = "engine.direct_share"


def _run(t0: float, scatters):
    """A recorded run of 1 s from ``t0`` with one flush on the flusher
    thread holding a ``flush.scatter`` span of each attributes in
    ``scatters``."""
    run = trace.Run()

    def add(name, a, b, thread, parent=None, attrs=None):
        s = trace.Span(name, t0 + a, thread, 1 if thread == "main" else 2,
                       parent.id if parent else None, run.id)
        s.t1, s.attrs = t0 + b, attrs
        run.spans.append(s)
        return s

    run.top = top = add("engine.align_all", 0.0, 1.0, "main")
    flush = add("engine.flush", 0.2, 0.9, "flusher", top)
    for k, attrs in enumerate(scatters):
        add("flush.scatter", 0.3 + 0.1 * k, 0.35 + 0.1 * k, "flusher", flush,
            attrs)
    return run


def _job(k: int, t0: float, t1: float):
    return harness.Job(k, 0, t0, t1, 0, 0, {}, {}, {}, {})


def _read(monkeypatch, runs, jobs):
    monkeypatch.setattr(trace, "_runs",
                        collections.deque(runs, maxlen=trace.KEEP))
    reader = spec.Bench(ROOT, BENCH).module("metrics", NAME)
    return reader.read(harness.Readings("ga", list(jobs), [0], None))


JOBS = (_job(0, 9.9, 11.1), _job(1, 19.95, 21.0))


def test_share_of_direct_pairs_over_the_jobs(monkeypatch):
    """Direct pairs over scattered pairs, summed over the jobs' runs:
    (300 + 100) / (300 + 100 + 400)."""
    runs = [_run(10.0, [{"pairs": 300, "direct": 300},
                        {"pairs": 100, "direct": 100}]),
            _run(20.0, [{"pairs": 400, "direct": 0}])]
    assert _read(monkeypatch, runs, JOBS) == pytest.approx(0.5)


@pytest.mark.parametrize("case", ["no-runs", "no-count", "none-scattered",
                                  "no-scatter", "unmatched"])
def test_nothing_to_read(monkeypatch, case):
    """No recorded runs, scatter spans without a ``direct`` count (the
    program before the direct scatter), nothing scattered, no scatter span
    or a job that holds no run: None."""
    full = [{"pairs": 10, "direct": 10}]
    runs = {"no-runs": [],
            "no-count": [_run(10.0, full), _run(20.0, [{"pairs": 10}])],
            "none-scattered": [_run(10.0, [{"pairs": 0, "direct": 0}]),
                               _run(20.0, [{"pairs": 0, "direct": 0}])],
            "no-scatter": [_run(10.0, []), _run(20.0, [])],
            "unmatched": [_run(10.0, full)]}[case]
    assert _read(monkeypatch, runs, JOBS) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "sequencealigner_tpu_torch.trace", None)
    reader = spec.Bench(ROOT, BENCH).module("metrics", NAME)
    assert reader.read(harness.Readings("ga", list(JOBS), [0], None)) is None


def _direct_available():
    from sequencealigner_tpu_torch.io import direct_fill
    from sequencealigner_tpu_torch.io.output import OutputStore

    return direct_fill.filler(OutputStore(2, triangular=False,
                                          spill=False)) is not None


def test_a_traced_run_scatters_every_pair_directly(tmp_path):
    """The small cell is tiles-v2 into a full store: the traced run reads
    1.0, and its pair arrays take no time."""
    if not _direct_available():
        pytest.skip("no native direct_fill library, or two cores or fewer")
    result, _, logs = run_cpu(tiny_bench(tmp_path), "tiny.cell", trace=True)
    assert result["correct"], logs[-6:]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m[NAME] == 1.0
    assert m["engine.materialize_ms"] == 0.0


def test_a_direct_scatter_that_drops_pairs_is_incorrect(tmp_path,
                                                        monkeypatch):
    """Every other launch group left out of the direct scatter: the
    comparison finds mismatched scores."""
    if not _direct_available():
        pytest.skip("no native direct_fill library, or two cores or fewer")
    from sequencealigner_tpu_torch.io import direct_fill

    filler = direct_fill.filler

    def halved(store):
        fill = filler(store)
        if fill is None:
            return None

        calls = []

        def every_other(buf, blocks):
            calls.append(1)
            return fill(buf, blocks) if len(calls) % 2 else 0

        return every_other

    monkeypatch.setattr(direct_fill, "filler", halved)
    # 300 sequences: several tiles, so several launch groups a job.
    many = {"n": 300, "lengths": {"min": 8, "max": 30}, "long_tail": None}
    result, _, _ = run_cpu(tiny_bench(tmp_path, workload=many), "tiny.cell")
    assert not result["correct"]
    assert result["checks"]["mismatched_scores"]["value"] > 0
