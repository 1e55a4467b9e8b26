"""The papillomavirus cell (configs/papillomavirus-ga-dnafull.json,
workloads/papillomavirus-ga.genomes.json) on the CPU: its frozen EDNAFULL
table is the one the program runs as ``dnafull``, its check passes a sound
run and fails a banded program and one that extends gaps by 3, and the two
readers of the program's launch counts (metrics/kernel.pairs_roofline.py,
metrics/dispatch.pairs_fill.py) read what the counts say, and nothing when
the counts are missing or disagree with the harness's cells."""

import collections
import json

import numpy as np
import pytest

from portbench.core import check, harness, profile, roofline, spec, traffic
from portbench.reference import dp, matrix
from portbench.tests.conftest import BENCH, ROOT, run_cpu, tiny_bench
from sequencealigner_tpu_torch import trace

CONFIG = "papillomavirus-ga-dnafull"
CELL = "papillomavirus-ga.genomes"
GAPS = (0, -16, -4)
READERS = ("kernel.pairs_roofline", "dispatch.pairs_fill")


def _bench():
    return spec.Bench(ROOT, BENCH)


def _numbers(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_dnafull_table_is_the_programs():
    """data/dnafull.txt holds the program's ``dnafull`` entry for entry, in
    the reference aligner's frame order (ATGCSWRYKMBVHDN): the benchmark
    scores what ``-m dnafull`` runs."""
    from sequencealigner_tpu_torch import matrices

    alphabet, sub, lut = matrix.load(BENCH / "data" / "dnafull.txt")
    prog = matrices.get("dnafull")
    assert alphabet == "ATGCSWRYKMBVHDN" == prog.alphabet[:15]
    np.testing.assert_array_equal(sub, prog.matrix[:15, :15])
    for ch in alphabet:
        assert lut[ord(ch)] == prog.lut[ord(ch)]
    assert sub[0, 0] == 5 and sub[0, 1] == -4 and sub[14, 14] == -1


def test_the_cell_draws_its_genomes():
    """Every set of the pool holds 256 genomes of 7,000-8,000 bases of
    ACGT at about GC 40%, and the cell reports gcups, setup_s and the two
    readers."""
    bench = _bench()
    cell = bench.cell(CELL)
    assert cell.config["name"] == CONFIG
    assert {m["name"] for m in cell.end_to_end} == {"gcups", "setup_s"}
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    lens, long = traffic.lengths_of(bench, cell, 0)
    assert len(lens) == 256 and not len(long)
    assert lens.min() >= 7000 and lens.max() <= 8000
    pool = traffic.make_pool(bench, cell, 2**31 + 16)
    data = pool[0].data
    assert set(np.unique(data).tobytes()) <= set(b"ACGT")
    gc = np.isin(data, np.frombuffer(b"GC", np.uint8)).mean()
    assert 0.39 < gc < 0.41


def _small(tmp_path, **workload):
    """A benchmark with a small cell of the papillomavirus configuration
    (by default 24 sequences of 30-200 bases, its lengths cut to match),
    read by the papillomavirus cell's own check."""
    check_of = json.loads((BENCH / "workloads" / f"{CELL}.json")
                          .read_text())["check"]
    wl = {"n": 24, "lengths": {"min": 30, "max": 200}, "long_tail": None,
          "check": check_of}
    wl.update(workload)
    conf = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    conf.update(name="papillomavirus-small", lengths={
        "model": "uniform", **wl["lengths"]})
    return tiny_bench(tmp_path, config="papillomavirus-small", workload=wl,
                      extra_files={"configs/papillomavirus-small.json":
                                   json.dumps(conf)})


@pytest.mark.parametrize("outer", ["1", "0"], ids=["tiles-v2", "linear-v1"])
def test_a_sound_run_is_correct(tmp_path, monkeypatch, outer):
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    result, _, logs = run_cpu(_small(tmp_path), "tiny.cell")
    assert result["correct"], logs[-6:]
    assert _numbers(result) == {"mismatched_scores": 0,
                                "nonzero_diagonal": 0}


def test_a_program_that_extends_by_3_is_incorrect(tmp_path, monkeypatch):
    """The program handed gap extend 3 where the configuration says 4."""
    from sequencealigner_tpu_torch import engine

    init = engine.Engine.__init__

    def extend_3(self, algo, sub, gaps, **kw):
        init(self, algo, sub, (gaps[0], gaps[1], -3), **kw)

    monkeypatch.setattr(engine.Engine, "__init__", extend_3)
    result, _, _ = run_cpu(_small(tmp_path), "tiny.cell")
    assert not result["correct"]
    assert _numbers(result)["mismatched_scores"] > 0


def test_a_banded_program_is_incorrect(tmp_path):
    """The reference with the DP cut to a band 64 cells wider than each
    pair's length difference, in the program's place, read by the cell's
    check.  Such a band holds the best path of these random genomes up to
    about 2,000 bases (0 of 66 pairs of 600-900 differed, 0 of 28 of
    1,500-2,000), so the test keeps the cell's own lengths and cuts the
    genomes to 6 a set."""
    bench = _small(tmp_path, n=6, lengths={"min": 7000, "max": 8000})
    cell = bench.cell("tiny.cell")
    _, sub, lut = matrix.load(bench.data("dnafull", ".txt"))
    seed = 2**31 + 64
    pool = traffic.make_pool(bench, cell, seed)
    sample = check.plan(pool[0], cell.workload["check"], seed, 0)
    full = check.reference_scores([sample], pool, lut, sub, "ga", GAPS,
                                  device="cpu", budget=1 << 20)
    keys, _ = full[0]
    st = pool[0]
    banded = dp.scores("ga", np.asarray(lut)[st.data], st.offsets,
                       keys // st.n, keys % st.n, sub, GAPS, budget=1 << 20,
                       band=64)
    pos = np.searchsorted(keys, np.minimum(sample.i, sample.j) * st.n
                          + np.maximum(sample.i, sample.j))
    sample.values = banded[pos]
    got = check.compare([sample], pool, full)
    assert got["distinct_pairs"] == 15
    assert got["numbers"]["mismatched_scores"] > 0
    assert not check.verdict(got["numbers"])


# The readers on hand-made runs of the program's recorder.

def _run(t0: float, launches, counts: bool = True):
    """A recorded run of 1 s from ``t0`` holding ``launches``, tuples of
    (kernel, pairs, cells, lanes, waves); without ``counts`` a run of a
    program that keeps no launch counts."""
    run = trace.Run()
    run.top = trace.Span(trace.TOP, t0, "main", 1, None, run.id)
    run.top.t1 = t0 + 1.0
    run.spans.append(run.top)
    for launch in launches:
        run.launch(*launch)
    if not counts:
        del run.dp_launches
    return run


def _kept(monkeypatch, runs):
    monkeypatch.setattr(trace, "_runs",
                        collections.deque(runs, maxlen=trace.KEEP))


def _job(k: int, t0: float, cells: int):
    return harness.Job(k, 0, t0 - 0.1, t0 + 1.1, cells, cells, {}, {}, {},
                       {})


def _trace(pairs_ms: float):
    return profile.TraceSummary(
        10.0, {0: 5.0}, {"tiles_kernel": 1.0, "pairs_kernel": pairs_ms,
                         "grid_kernel": 0.0}, {}, [], [])


#: Two jobs: tiles and the diagonal remainder, then linear-v1 alone.
LAUNCHES = ([("align_tiles", 4096, 6_000_000, 1, 12.5),
             ("align_pairs", 2016, 1_000_000, 4, 0.25)],
            [("align_pairs", 32_640, 3_000_000, 2, 1.5)])
CELLS = (7_000_000, 3_000_000)


def _readings(monkeypatch, *, pairs_ms=2.0, counts=True, cells=CELLS):
    _kept(monkeypatch, [_run(10.0, LAUNCHES[0], counts),
                        _run(20.0, LAUNCHES[1], counts)])
    return harness.Readings("ga", [_job(0, 10.0, cells[0]),
                                   _job(1, 20.0, cells[1])], [0],
                            _trace(pairs_ms))


def test_readers_read_the_counts(monkeypatch):
    r = _readings(monkeypatch)
    bench = _bench()
    roof = bench.module("metrics", "kernel.pairs_roofline").read(r)
    assert roof == pytest.approx(100 * roofline.bound_ms(4_000_000, "ga")
                                 / 2.0)
    fill = bench.module("metrics", "dispatch.pairs_fill").read(r)
    want = (1_000_000 * 0.25 + 3_000_000 * 0.75) / 4_000_000
    assert fill == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_counts_read_nothing(monkeypatch, name):
    """A program without launch counts (the parent of the change that
    brought them), counts whose cells disagree with the harness's, jobs
    holding no run, and no jobs: None, no raise."""
    reader = _bench().module("metrics", name)
    assert reader.read(_readings(monkeypatch, counts=False)) is None
    assert reader.read(_readings(monkeypatch, cells=(7_000_000, 3_000_001))
                       ) is None
    r = _readings(monkeypatch)
    assert reader.read(harness.Readings("ga", [_job(0, 50.0, 1)], [0],
                                        r.trace)) is None
    assert reader.read(harness.Readings("ga", [], [0], r.trace)) is None


def test_roofline_without_a_trace_or_kernel_time_reads_nothing(monkeypatch):
    reader = _bench().module("metrics", "kernel.pairs_roofline")
    r = _readings(monkeypatch, pairs_ms=0.0)
    assert reader.read(r) is None
    r.trace = None
    assert reader.read(r) is None


def test_fill_without_a_card_reads_nothing(monkeypatch):
    """On the CPU a launch has no resident grid (waves 0)."""
    _kept(monkeypatch, [_run(10.0, [("align_pairs", 10, 500, 1, 0.0)])])
    r = harness.Readings("ga", [_job(0, 10.0, 500)], [0], None)
    assert _bench().module("metrics", "dispatch.pairs_fill").read(r) is None
