"""The generator: cells, seeded length models and their truncation."""

import itertools
import json

import numpy as np
import pytest

from portbench.core import roofline, spec, traffic
from portbench.tests.conftest import BENCH, ROOT


def bench():
    return spec.Bench(ROOT, BENCH)


def test_cells_is_the_sum_over_pairs():
    ls = [3, 10, 1, 7, 7]
    assert traffic.cells(ls) == sum(a * b for a, b in
                                    itertools.combinations(ls, 2))
    assert traffic.cells(np.array([1023] * 3, np.int32)) == 3 * 1023 ** 2


@pytest.mark.parametrize("model,params", [
    ("lognormal", {"median": 300, "sigma": 0.6}),
    ("uniform", {"min": 8, "max": 50}),
])
def test_length_models_are_seeded_and_truncated(model, params):
    mod = bench().module("lengths", model)
    a = mod.draw(np.random.default_rng(5), 5000, params, 10, 1023)
    b = mod.draw(np.random.default_rng(5), 5000, params, 10, 1023)
    c = mod.draw(np.random.default_rng(6), 5000, params, 10, 1023)
    assert (a == b).all() and not (a == c).all()
    assert a.min() >= 10 and a.max() <= 1023
    if model == "lognormal":
        # Truncation by drawing again keeps the body of the distribution.
        assert 280 <= np.median(a) <= 320
        t = mod.draw(np.random.default_rng(5), 5000, params, 10, 200)
        assert t.max() <= 200 and t.min() >= 10


def test_sizes_are_fixed_and_the_seed_draws_residues_and_order(tmp_path):
    from portbench.tests.conftest import tiny_bench

    name = "swissprot-ga.longtail"
    b = tiny_bench(tmp_path, name=name, workload=json.loads(
        (BENCH / "workloads" / f"{name}.json").read_text()))
    cell = b.cell(name)
    p1 = traffic.make_pool(b, cell, 1)
    p2 = traffic.make_pool(b, cell, 2**31 + 11)
    p3 = traffic.make_pool(b, cell, 1)
    for x, y, z in zip(p1, p2, p3):
        assert sorted(x.lengths) == sorted(y.lengths)
        assert (x.data == z.data).all() and (x.offsets == z.offsets).all()
        assert not (x.lengths == y.lengths).all()
        assert traffic.cells(x.lengths) == traffic.cells(y.lengths)
        ls = x.lengths
        assert len(x.long) == 4
        assert (ls[x.long] >= 4097).all() and (ls[x.long] <= 9000).all()
        assert ls.min() >= 10 and ls.max() <= 9000
        assert set(np.unique(x.data)) <= set(b"ARNDCQEGHILKMFPSTWYV")
    assert sorted(p1[0].lengths) != sorted(p1[1].lengths)


def test_composition_is_normalised():
    res, p = traffic.composition(bench(), "swissprot_composition")
    assert len(res) == 20 and abs(p.sum() - 1) < 1e-12
    table = json.loads((BENCH / "data" / "swissprot_composition.json")
                       .read_text())["percent"]
    assert abs(p[0] - table["A"] / sum(table.values())) < 1e-12


def test_frozen_bound_is_the_hand_worked_rate():
    # GA: 3 ALU instructions a cell at 64 a clock: 3/64 clock per cell and
    # SM; 132 SMs x 1.98e9 / (3/64) = 5,575.68e9 cells a second.
    assert roofline.peak_gcups("ga") == pytest.approx(5575.68)
    assert roofline.bound_ms(5575.68e9, "ga") == pytest.approx(1000.0)
    assert roofline.bound_ms(10**12, "nw") == pytest.approx(
        1e12 * (2 / 64) / (132 * 1.98e9) * 1e3)
    assert roofline.bound_ms(10**12, "sw") == pytest.approx(
        1e12 * (3.5 / 64) / (132 * 1.98e9) * 1e3)
