"""The comparison that decides ``correct`` passes a sound run and fails the
control and each fault a cell can have, with the timed path broken under a
run of the harness (on the CPU, through the program's plain versions)."""

import json

import numpy as np
import pytest

from portbench.reference import dp
from portbench.tests.conftest import BENCH, run_cpu, tiny_bench


def _numbers(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def _local():
    """A Smith-Waterman configuration of the test: the Swiss-Prot one with
    local alignment, for the per-pair kernel's other recurrence."""
    conf = json.loads((BENCH / "configs" / "swissprot-ga-blosum62.json")
                      .read_text())
    conf.update(name="swissprot-sw-blosum62", algorithm="sw")
    return {"configs/swissprot-sw-blosum62.json": json.dumps(conf)}


@pytest.mark.parametrize("config", ["swissprot-ga-blosum62",
                                    "swissprot-sw-blosum62"])
def test_a_sound_run_is_correct(tmp_path, config):
    extra = _local() if config == "swissprot-sw-blosum62" else None
    result, bad, logs = run_cpu(tiny_bench(tmp_path, config=config,
                                           extra_files=extra), "tiny.cell")
    assert result["correct"], logs[-6:]
    assert _numbers(result) == {"mismatched_scores": 0,
                                "nonzero_diagonal": 0}
    assert result["attempted"] >= 1 and result["failed"] == 0
    read = next(line for line in logs if line.startswith("reference:"))
    # Random and near pairs and every pair of the long tail were read.
    assert "'long_tail': 156" in read


#: A set of several tiles, so that four lanes each get launch groups.
FOUR = {"n": 300, "lengths": {"min": 8, "max": 30}, "long_tail": None}


def _spread(monkeypatch):
    """One tile a launch group, so that a small set's groups spread over
    the lanes as a large combo's split does on four cards."""
    engine, _, _ = _program()
    monkeypatch.setattr(engine.Engine, "_tile_group",
                        lambda self, Lc, Lk, n: 1)


def test_a_sound_run_on_four_lanes_is_correct(tmp_path, monkeypatch):
    _spread(monkeypatch)
    result, _, logs = run_cpu(tiny_bench(tmp_path, chips=4,
                                         workload=FOUR), "tiny.cell")
    assert result["correct"], logs[-6:]
    assert result["device"]["count"] == 4


def _program():
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.io import output
    from sequencealigner_tpu_torch.ops import cuda_dp

    return engine, output, cuda_dp


def _unchanged(monkeypatch):
    """A job that returns its state unchanged: nothing is scored."""
    engine, _, _ = _program()
    monkeypatch.setattr(engine.Engine, "align_all",
                        lambda self, ss, store, **kw: engine.AlignStats())


def _half(monkeypatch):
    """Half of each flush's pairs left out of the store."""
    _, output, _ = _program()
    fill = output.OutputStore.fill_pairs

    def half(self, i, j, s):
        k = len(s) // 2
        return fill(self, i[:k], j[:k], s[:k])

    monkeypatch.setattr(output.OutputStore, "fill_pairs", half)


def _no_exchange(monkeypatch):
    """Scores of every lane but the first never come home."""
    engine, _, _ = _program()
    _spread(monkeypatch)
    enqueue = engine.Engine._enqueue

    def first_lane_only(self, dev, part, pending, lane):
        if lane == 0:
            enqueue(self, dev, part, pending, lane)

    monkeypatch.setattr(engine.Engine, "_enqueue", first_lane_only)


def _altered(monkeypatch):
    """Answers altered where the kernels produce them."""
    _, _, cuda_dp = _program()
    for name in ("align_tiles", "align_pairs"):
        kernel = getattr(cuda_dp, name)

        def wrong(*a, _k=kernel, **kw):
            out = _k(*a, **kw)
            out.view(-1)[::7] += 1
            return out

        wrong.launches, wrong.launches_by_device = 0, {}
        monkeypatch.setattr(cuda_dp, name, wrong)


@pytest.mark.parametrize("fault,chips", [
    (_unchanged, 1), (_half, 1), (_no_exchange, 4), (_altered, 1)])
def test_each_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault,
                                            chips):
    fault(monkeypatch)
    bench = tiny_bench(tmp_path, chips=chips,
                       workload=FOUR if chips == 4 else None)
    result, _, _ = run_cpu(bench, "tiny.cell")
    assert not result["correct"]
    assert _numbers(result)["mismatched_scores"] > 0


def test_the_control_in_the_programs_place_is_incorrect(tmp_path,
                                                        monkeypatch):
    """The control: the reference with the DP cut to a band 8 cells wider
    than the pair's length difference, the shortcut that would raise GCUPS
    by skipping cells, put in the program's place."""
    engine, _, _ = _program()

    def banded(self, ss, store, **kw):
        i, j = np.triu_indices(ss.num, 1)
        s = dp.scores("ga", np.asarray(ss.lut)[ss.data], ss.offsets, i, j,
                      self.sub_for_control, (0, -10, -1), band=8)
        store.fill_pairs(i, j, s.astype(np.int32))
        return engine.AlignStats()

    from portbench.reference import matrix

    monkeypatch.setattr(engine.Engine, "sub_for_control",
                        matrix.load(BENCH / "data" / "blosum62.txt")[1],
                        raising=False)
    monkeypatch.setattr(engine.Engine, "align_all", banded)
    bench = tiny_bench(tmp_path, workload={
        "lengths": {"min": 40, "max": 60}, "long_tail": None})
    result, _, _ = run_cpu(bench, "tiny.cell")
    assert not result["correct"]
    assert _numbers(result)["mismatched_scores"] > 0
