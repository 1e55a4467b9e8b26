"""BENCHMARK.json keeps to its contract, and a cell is found by name."""

import json

from portbench.core import spec
from portbench.tests.conftest import BENCH, ROOT, run_cpu, tiny_bench

SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_names_units_and_lines_use_the_allowed_characters():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        spec.check_name(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert all(spec.NAME.fullmatch(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            spec.check_name(w[k])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == names
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        spec.check_name(m["name"])
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        cell = spec.Bench(ROOT, BENCH).cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_bad_names_and_units_are_refused():
    import pytest

    for bad in ("a b", "a/b", "", ".x", "x" * 65, "µs"):
        with pytest.raises(ValueError):
            spec.check_name(bad)
    for bad in ("tokens per s", "", "x" * 17, "µs"):
        with pytest.raises(ValueError):
            spec.check_unit(bad)
    assert spec.check_unit("tokens/s") == "tokens/s"


FLAT = '''"""A length model of the test: every length the same."""
import numpy as np


def draw(rng, n, params, lo, hi):
    return np.full(n, min(max(params["length"], lo), hi), np.int64)
'''

JOBS = '''"""A per-layer metric of the test: jobs in the window."""


def read(r):
    return float(len(r.jobs))
'''


def test_a_new_cell_config_length_model_and_metric_are_files_alone(
        tmp_path):
    """A throwaway cell, with a configuration, a length model and a
    per-layer metric of its own, all as new files in a temporary
    directory, runs through the harness as it stands."""
    conf = json.loads((BENCH / "configs" / "avppred-ga-blosum62.json")
                      .read_text())
    conf.update(name="flat-ga-blosum62",
                lengths={"model": "flat", "length": 33})
    bench = tiny_bench(
        tmp_path, name="flat-ga.t",
        workload={"long_tail": None, "lengths": {"min": 8, "max": 50}},
        extra_files={"lengths/flat.py": FLAT, "metrics/test.jobs.py": JOBS,
                     "configs/flat-ga-blosum62.json": json.dumps(conf)})
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "flat-ga-blosum62", "source": "test",
                         "file": "bench/configs/flat-ga-blosum62.json",
                         "reduced": [], "why": "test"})
    b["workloads"][-1]["config"] = "flat-ga-blosum62"
    b["per_layer"].append({"name": "test.jobs", "unit": "jobs",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "gcups",
                           "workloads": ["flat-ga.t"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    bench = spec.Bench(tmp_path, bench.dir)
    cell = bench.cell("flat-ga.t")
    assert cell.config["name"] == "flat-ga-blosum62"
    assert "test.jobs" in {m["name"] for m in cell.per_layer}
    result, bad, logs = run_cpu(bench, "flat-ga.t", trace=True)
    assert result["correct"] and not bad
    assert result["metrics"]["test.jobs"]["value"] >= 1
    assert any("33-33" in line for line in logs)
    result, _, _ = run_cpu(bench, "flat-ga.t")
    assert set(result["metrics"]) == {"gcups", "setup_s"}
    assert list(result)[-1] == "checks"
