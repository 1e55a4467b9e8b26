"""The engine's spans (sequencealigner_tpu_torch/trace.py) on the CPU: the
span tree of a run, the ``[phases]`` line derived from it, the flushes
counted by cause, nothing recorded with the variable unset, the spans of
both threads on a torch.profiler trace's clock, and -t's one trace file."""

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from sequencealigner_tpu_torch import cli, engine, matrices, trace
from sequencealigner_tpu_torch.io import direct_fill
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.tools import profile_main

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)
LINE = re.compile(r"\[phases\] wall=(\d+\.\d)ms((?:  [\w.+]+=-?\d+\.\dms)+)")
MAIN = ("engine.align_all", "engine.pack", "engine.dispatch",
        "engine.flush_join", "engine.final")


def _seqs():
    """64 short and 64 longer proteins: two buckets."""
    rng = np.random.default_rng(8)
    return [rng.choice(AA, int(n))
            for n in np.r_[rng.integers(4, 13, 64), rng.integers(40, 61, 64)]]


def _run(monkeypatch, outer: str, full: bool, record: bool = True,
         merger=None):
    """(stats, stdout, store, run or None) of one align_all of _seqs()."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    seqs = _seqs()
    eng = engine.Engine("ga", M.matrix, GAPS, device="cpu")
    store = (OutputStore(len(seqs), triangular=False, spill=False)
             if full else None)
    before = trace.runs()[-1:]
    env = {"SEQALIGN_TPU_DEBUG_PHASES": "1"} if record else {}
    out = io.StringIO()
    with mock.patch.dict("os.environ", env), contextlib.redirect_stdout(out):
        stats = eng.align_all(SequenceSet.from_list(seqs, M.lut), store,
                              progress=False, merger=merger)
    after = trace.runs()[-1:]
    run = after[0] if after != before else None
    return stats, out.getvalue(), store, run


MODES = [("1", True), ("1", False), ("0", True), ("0", False)]
IDS = ["tiles-v2-store", "tiles-v2-no-store", "linear-v1-store",
       "linear-v1-no-store"]


def _identity(i, j, s):
    return i, j, s


@pytest.mark.parametrize("flush_pairs", [None, 4096], ids=["eager", "forced"])
@pytest.mark.parametrize("outer,full", MODES, ids=IDS)
def test_span_tree(monkeypatch, outer, full, flush_pairs):
    if flush_pairs:
        monkeypatch.setattr(engine, "FLUSH_PAIRS", flush_pairs)
    stats, _, _, run = _run(monkeypatch, outer, full)
    assert run is not None and run.top.name == trace.TOP
    by_id = {s.id: s for s in run.spans}
    assert len(by_id) == len(run.spans)
    assert {s.run for s in run.spans} == {run.id}
    assert all(s.t1 is not None and s.t1 >= s.t0 for s in run.spans)
    top = run.top
    assert top.parent is None and top.attrs == {
        "pairs": stats.pairs, "cells": stats.cells, "lanes": 1,
        "schedule": "tiles-v2" if outer == "1" else "linear-v1"}
    main_tid = top.tid
    for s in run.spans:
        assert top.t0 <= s.t0 and s.t1 <= top.t1, s.name
        if s is top:
            continue
        parent = by_id[s.parent]  # every parent in the same run
        if s.name in MAIN:
            assert s.thread == "main" and s.tid == main_tid
        if s.tid == parent.tid:
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1, s.name
            assert s.thread == parent.thread
        if s.name == "engine.flush":
            assert parent.tid == main_tid and parent.name in (
                "engine.dispatch", "engine.final")
            assert s.attrs["cause"] in ("forced", "eager", "final")
            assert (s.thread == "main") == (s.attrs["cause"] == "final")
            assert s.attrs["d2h_bytes"] == 0  # no copy on the CPU
        elif s.name.startswith("flush."):
            assert parent.name == "engine.flush" and s.tid == parent.tid
        elif s.name == "engine.flush_join":
            assert parent.name in ("engine.dispatch", "engine.final")
    flushes = run.named("engine.flush")
    assert sum(f.attrs["pairs"] for f in flushes) == stats.pairs
    assert {f.thread for f in flushes} >= {"flusher"}
    if flush_pairs:
        assert run.causes.get("forced", 0) >= 1
    scatters = run.named("flush.scatter")
    scattered = sum(s.attrs["pairs"] for s in scatters)
    assert scattered == (stats.pairs if full else 0)
    # Either schedule into a plain store scatters every pair directly,
    # with no pair arrays.
    direct = full and direct_fill.filler(
        OutputStore(2, triangular=False, spill=False)) is not None
    assert sum(s.attrs["direct"] for s in scatters) == (
        stats.pairs if direct else 0)
    if direct:
        assert all(s.attrs["direct"] == s.attrs["pairs"] for s in scatters)
        assert not run.named("flush.materialize")
    pack, = run.named("engine.pack")
    assert pack.attrs == {"buckets": 2, "h2d_bytes": 0}
    dispatch, = run.named("engine.dispatch")
    assert dispatch.attrs == {"launches": stats.lane_launches}


def _line(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("[phases]")]
    assert len(lines) == 1, out
    m = LINE.fullmatch(lines[0])
    assert m, lines[0]
    parts = dict(p.split("=") for p in m.group(2).split())
    return float(m.group(1)), {k: float(v[:-2]) for k, v in parts.items()}


@pytest.mark.parametrize("outer,full", MODES, ids=IDS)
def test_phase_line_is_the_sums_of_its_spans(monkeypatch, outer, full):
    stats, out, _, run = _run(monkeypatch, outer, full)
    wall, phases = _line(out)
    flush = run.total("engine.flush")
    mat = run.total("flush.materialize")
    want = {
        "schedule+dispatch": run.total("engine.pack")
        + run.total("engine.dispatch"),
        "flush.fetch_wait": flush - mat - run.total("flush.scatter")
        - run.total("flush.commit"),
        "final_flush": run.total("engine.final"),
    }
    if full:
        want["flush.materialize"] = mat
    assert set(phases) == set(want)
    for k, v in want.items():
        assert abs(phases[k] - v * 1e3) <= 0.05 + 1e-9, k
    assert abs(wall - stats.seconds * 1e3) <= 0.05 + 1e-9


@pytest.mark.parametrize("outer,full", MODES, ids=IDS)
def test_flushes_counted_by_cause(monkeypatch, outer, full):
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 4096)
    _, _, _, run = _run(monkeypatch, outer, full)
    spans: dict = {}
    for f in run.named("engine.flush"):
        spans[f.attrs["cause"]] = spans.get(f.attrs["cause"], 0) + 1
    assert run.causes == spans and sum(spans.values()) >= 2


def test_merger_flushes_on_the_main_thread(monkeypatch):
    """Under a merger every flush runs on the main thread, counted as
    ``merger`` and ``final``, and the merge is inside its scatter."""
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 4096)
    stats, _, store, run = _run(monkeypatch, "1", True, merger=_identity)
    flushes = run.named("engine.flush")
    assert {f.thread for f in flushes} == {"main"}
    assert run.causes["final"] == 1 and run.causes["merger"] >= 2
    assert sum(run.causes.values()) == len(flushes)
    assert len(run.named("flush.scatter")) == len(flushes)
    assert all(s.attrs["direct"] == 0 for s in run.named("flush.scatter"))
    assert not run.named("engine.flush_join")


@pytest.mark.parametrize("outer,full", MODES, ids=IDS)
def test_unset_records_nothing(monkeypatch, outer, full):
    def refuse(*a, **k):
        raise AssertionError("a span was recorded with the variable unset")

    monkeypatch.delenv("SEQALIGN_TPU_DEBUG_PHASES", raising=False)
    _, _, rec_store, run = _run(monkeypatch, outer, full)
    assert run is not None
    kept = trace.runs()
    monkeypatch.setattr(trace, "Run", refuse)
    plain, out, plain_store, none = _run(monkeypatch, outer, full,
                                         record=False)
    assert none is None and "[phases]" not in out and trace.runs() == kept
    assert (plain.pairs, plain.cells) == (run.top.attrs["pairs"],
                                          run.top.attrs["cells"])
    if full:
        np.testing.assert_array_equal(np.asarray(plain_store.matrix),
                                      np.asarray(rec_store.matrix))


@pytest.mark.parametrize("outer,full", MODES, ids=IDS)
def test_launch_counts_hold_every_cell(monkeypatch, outer, full):
    """A recorded run counts each DP launch once, on the CPU with G 1 and
    no waves, and the launches hold every pair and true cell."""
    stats, _, _, run = _run(monkeypatch, outer, full)
    lengths = np.array([len(s) for s in _seqs()], np.int64)
    cells = (lengths.sum() ** 2 - (lengths ** 2).sum()) // 2
    launches = run.dp_launches
    assert sum(x.cells for x in launches) == stats.cells == cells
    assert sum(x.pairs for x in launches) == stats.pairs
    dispatch, = run.named("engine.dispatch")
    assert len(launches) == sum(dispatch.attrs["launches"])
    assert {x.kernel for x in launches} == (
        {"align_tiles", "align_pairs"} if outer == "1" else {"align_pairs"})
    assert {(x.lanes, x.waves, x.bits) for x in launches} == {(1, 0.0, 32)}


@pytest.mark.parametrize("outer", ["1", "0"], ids=["tiles-v2", "linear-v1"])
def test_unset_counts_no_cells_on_one_entry(monkeypatch, outer):
    """With recording off a run on one entry counts no launch and builds
    no block cell counter (only _pick over several entries and the
    striping over hosts read it)."""
    def refuse(*a, **k):
        raise AssertionError("counted with recording off on one entry")

    monkeypatch.delenv("SEQALIGN_TPU_DEBUG_PHASES", raising=False)
    monkeypatch.setattr(engine, "_BlockCells", refuse)
    monkeypatch.setattr(trace.Run, "launch", refuse)
    stats, out, store, run = _run(monkeypatch, outer, True, record=False)
    assert run is None and "[phases]" not in out
    assert stats.pairs == len(_seqs()) * (len(_seqs()) - 1) // 2


def test_trace_file_holds_the_launch_counts():
    """add_chrome_events gives the run's engine.align_all event its launch
    counts, one object of Launch's fields each, and adds no event."""
    run = trace.Run()
    run.profiled = True
    run.top = run.begin(trace.TOP, None, "main")
    run.launch("align_pairs", 32640, 1_836_000_000_000, 2, 1.9318)
    run.end(run.top)
    events = [{"ph": "X", "cat": "cpu_op", "name": trace.TOP, "ts": 5.0,
               "dur": 1.0, "pid": 1, "tid": 1}]
    assert trace.add_chrome_events(events, [run]) == 1
    assert events[-1]["args"]["dp_launches"] == [{
        "kernel": "align_pairs", "pairs": 32640,
        "cells": 1_836_000_000_000, "lanes": 2, "waves": 1.9318,
        "bits": 32}]


def test_launch_bits_default_to_32():
    """A Launch records the bits of the form the wrapper ran; a record
    made without them (a caller of the older five fields) reads 32."""
    run = trace.Run()
    run.launch("align_tiles", 4096, 6_000_000, 1, 12.5, 16)
    run.launch("align_pairs", 2016, 1_000_000, 4, 0.25)
    assert [x.bits for x in run.dp_launches] == [16, 32]
    assert trace.Launch("align_tiles", 1, 1, 1, 0.0).bits == 32
    assert trace.Launch._fields[-1] == "bits"


def test_spans_on_the_profilers_clock(monkeypatch):
    """Under a CPU torch.profiler the flusher's spans join the trace on
    their own thread, and the run's mapped end meets its profiler range's
    end within 0.1 ms."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, _, run = _run(monkeypatch, "1", True)
    assert run.profiled
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == trace.TOP]
    assert len(ranges) == 1
    added = trace.add_chrome_events(
        events, [r for r in trace.runs() if r.top.t0 >= t0])
    assert added == len(run.spans)
    mine = [e for e in events if e.get("cat") == "engine"]
    flusher = [e for e in mine if e["args"]["thread"] == "flusher"]
    assert flusher and {e["tid"] for e in flusher}.isdisjoint(
        {ranges[0]["tid"]})
    assert {e["args"]["run"] for e in mine} == {run.id}
    top, = (e for e in mine if e["name"] == trace.TOP)
    end = ranges[0]["ts"] + ranges[0]["dur"]
    assert abs(top["ts"] + top["dur"] - end) <= 100.0
    assert top["tid"] == ranges[0]["tid"]


def test_add_chrome_events_needs_one_range_a_run():
    with pytest.raises(ValueError):
        run = trace.Run()
        run.profiled = True
        run.top = trace.Span(trace.TOP, 1.0, "main", 1, None, run.id)
        run.top.t1 = 2.0
        trace.add_chrome_events([], [run])


def test_cli_trace_holds_the_flushers_spans(tmp_path, monkeypatch):
    """-C -t DIR on _seqs() (three launches) writes one trace file whose
    engine.flush spans include one on a thread other than the main one."""
    monkeypatch.delenv("SEQALIGN_TPU_DEBUG_PHASES", raising=False)
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(f">s{k}\n{bytes(x).decode()}\n"
                             for k, x in enumerate(_seqs())))
    tdir = tmp_path / "trace"
    rc = cli.run(["-i", str(fasta), "-o",
                  str(tmp_path / "o.h5"), "-m", "blosum62", "-a", "ga",
                  "-p", "4", "-F", "-P", "-Q", "-C", "-t", str(tdir)])
    assert rc == 0
    assert "SEQALIGN_TPU_DEBUG_PHASES" not in os.environ
    files = list(tdir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    top, = (e for e in events if e.get("cat") == "engine"
            and e["name"] == trace.TOP)
    flushes = [e for e in events if e.get("cat") == "engine"
               and e["name"] == "engine.flush"]
    assert any(e["tid"] != top["tid"] and e["args"]["thread"] == "flusher"
               for e in flushes), flushes


def test_runs_inside_matches_one_run_an_interval(monkeypatch):
    a = _run(monkeypatch, "1", False)[3]
    b = _run(monkeypatch, "1", False)[3]
    assert trace.runs_inside([(a.top.t0, a.top.t1)]) == [a]
    assert trace.runs_inside([(a.top.t0, b.top.t1)]) is None
    assert trace.runs_inside([(a.top.t1 + 1e6, a.top.t1 + 2e6)]) is None
    assert trace.runs_inside([]) is None


def test_idle_split_names_each_gap_by_both_threads():
    """profile_main.idle_split on a hand-made trace: two kernels inside one
    run leave three gaps, named by each thread's innermost span."""
    def span(name, thread, ts, dur, tid):
        return {"ph": "X", "cat": "engine", "name": name, "ts": ts,
                "dur": dur, "tid": tid, "args": {"thread": thread}}

    events = [
        span("engine.align_all", "main", 0, 100, 1),
        span("engine.dispatch", "main", 0, 60, 1),
        span("engine.flush_join", "main", 40, 20, 1),
        span("engine.final", "main", 60, 40, 1),
        span("engine.flush", "flusher", 30, 30, 2),
        span("flush.materialize", "flusher", 35, 20, 2),
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 50, "dur": 30},
    ]
    split = profile_main.idle_split(events)
    assert split == pytest.approx({
        "dispatch / -": 10e-6,
        "flush_join / flush.materialize": 20e-6,
        "final / -": 20e-6,
    })


def test_spans_from_many_threads_are_all_kept():
    """Threads that record into one run at once (the main thread and the
    flusher do) lose no span and share no id."""
    run = trace.Run()
    run.top = run.begin(trace.TOP, None, "main")
    per, workers = 2000, 16

    def work():
        for _ in range(per):
            run.end(run.begin("flush.select", run.top, "flusher"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(run.spans) == 1 + per * workers
    assert len({s.id for s in run.spans}) == len(run.spans)
