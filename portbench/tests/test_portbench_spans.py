"""The readers of the engine's spans (metrics/engine.pack_ms.py,
engine.dispatch_self_ms, engine.join_wait_ms, engine.scatter_ms,
engine.flusher_share) on hand-made runs of the program's recorder, and on
a traced run of a small cell on the CPU."""

import collections
import sys

import pytest

from portbench.core import harness, spec
from portbench.tests.conftest import BENCH, ROOT, run_cpu, tiny_bench
from sequencealigner_tpu_torch import trace

READERS = ("engine.pack_ms", "engine.dispatch_self_ms", "engine.join_wait_ms",
           "engine.scatter_ms", "engine.flusher_share")
#: What each reader gives on two jobs of _run()'s shape.
WANT = {"engine.pack_ms": 100.0, "engine.dispatch_self_ms": 350.0,
        "engine.join_wait_ms": 150.0, "engine.scatter_ms": 150.0,
        "engine.flusher_share": 0.45}


def _run(t0: float):
    """A recorded run of 1 s from ``t0``: pack 0.1 s; dispatch 0.5 s with
    two waits on the flusher (0.1 + 0.05 s) and one flush on the flusher
    thread (0.2 s, scatter 0.05 s); final 0.4 s with one wait (0.1 s) and
    the last flush on the main thread (0.25 s, scatter 0.1 s)."""
    run = trace.Run()

    def add(name, a, b, thread, parent=None):
        s = trace.Span(name, t0 + a, thread, 1 if thread == "main" else 2,
                       parent.id if parent else None, run.id)
        s.t1 = t0 + b
        run.spans.append(s)
        return s

    run.top = top = add("engine.align_all", 0.0, 1.0, "main")
    add("engine.pack", 0.0, 0.1, "main", top)
    disp = add("engine.dispatch", 0.1, 0.6, "main", top)
    add("engine.flush_join", 0.3, 0.4, "main", disp)
    add("engine.flush_join", 0.5, 0.55, "main", disp)
    flush = add("engine.flush", 0.2, 0.4, "flusher", disp)
    add("flush.scatter", 0.3, 0.35, "flusher", flush)
    final = add("engine.final", 0.6, 1.0, "main", top)
    add("engine.flush_join", 0.6, 0.7, "main", final)
    flush = add("engine.flush", 0.7, 0.95, "main", final)
    add("flush.scatter", 0.8, 0.9, "main", flush)
    return run


def _job(k: int, t0: float, t1: float):
    return harness.Job(k, 0, t0, t1, 0, 0, {}, {}, {}, {})


def _readings(*jobs):
    return harness.Readings("ga", list(jobs), [0], None)


def _bench():
    return spec.Bench(ROOT, BENCH)


def _kept(monkeypatch, runs):
    monkeypatch.setattr(trace, "_runs",
                        collections.deque(runs, maxlen=trace.KEEP))


@pytest.mark.parametrize("name", READERS)
def test_reader_on_recorded_runs(monkeypatch, name):
    _kept(monkeypatch, [_run(5.0), _run(10.0), _run(20.0)])
    r = _readings(_job(0, 9.9, 11.1), _job(1, 19.95, 21.0))
    assert _bench().module("metrics", name).read(r) == pytest.approx(
        WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_match_reads_nothing(monkeypatch, name):
    reader = _bench().module("metrics", name)
    _kept(monkeypatch, [_run(10.0), _run(12.0)])
    # A job holding no run, a job holding two, and no runs at all.
    assert reader.read(_readings(_job(0, 9.9, 11.1), _job(1, 30, 31))) is None
    assert reader.read(_readings(_job(0, 9.9, 13.1))) is None
    assert reader.read(_readings()) is None
    _kept(monkeypatch, [])
    assert reader.read(_readings(_job(0, 9.9, 11.1))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_spans_reads_nothing(monkeypatch, name):
    """The parent of the change that brought the recorder has no
    ``sequencealigner_tpu_torch.trace``: the reader gives None and does not
    raise."""
    reader = _bench().module("metrics", name)
    monkeypatch.setitem(sys.modules, "sequencealigner_tpu_torch.trace", None)
    assert reader.read(_readings(_job(0, 9.9, 11.1))) is None


def test_a_traced_run_reports_the_spans(tmp_path):
    """A traced run of a small cell on the CPU prints the five readings,
    and pack + dispatch self + join wait is the [phases] line's
    schedule+dispatch (``engine.dispatch_ms``) within 1%."""
    result, _, logs = run_cpu(tiny_bench(tmp_path), "tiny.cell", trace=True)
    assert result["correct"], logs[-6:]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(m)
    parts = (m["engine.pack_ms"] + m["engine.dispatch_self_ms"]
             + m["engine.join_wait_ms"])
    assert parts == pytest.approx(m["engine.dispatch_ms"], rel=0.01, abs=0.1)
    assert 0 < m["engine.flusher_share"] < 1
