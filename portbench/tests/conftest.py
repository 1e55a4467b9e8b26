"""Shared fixtures of the benchmark's tests: a throwaway benchmark in a
temporary directory, holding copies of this benchmark's files and one
small cell of its own, run on the CPU through the program's plain
versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(1)


def tiny_bench(tmp: Path, *, chips: int = 1, name: str = "tiny.cell",
               config: str = "swissprot-ga-blosum62",
               workload: dict | None = None, extra_files: dict | None = None):
    """A benchmark at ``tmp`` with one extra cell ``name`` of ``config``:
    40 sequences of 10-60 residues, two of them 70-90, one set in the
    pool."""
    from portbench.core import spec

    bdir = tmp / "bench"
    shutil.copytree(BENCH, bdir, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": name, "config": config,
                           "traffic": "tiny", "chips": chips,
                           "why": "a test's cell"})
    for m in b["per_layer"]:
        m["workloads"].append(name)
    wl = {"n": 40,
          "lengths": {"min": 10, "max": 60},
          "long_tail": {"count": 2, "min": 70, "max": 90}, "pool": 1,
          "check": {"random_pairs": 4000, "near_pairs": 200,
                    "long_pairs": {"every_in_first_jobs": 1, "sample": 64}},
          "why": "a test's cell"}
    wl.update(workload or {})
    (bdir / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    for rel, text in (extra_files or {}).items():
        (bdir / rel).write_text(text)
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.Bench(tmp, bdir)


def run_cpu(bench, cell_name: str, *, seed: int = 2**31 + 7,
            trace: bool = False):
    """One run of a cell on the CPU: the harness's run without its look for
    a chip."""
    import time

    from portbench.core import harness

    cell = bench.cell(cell_name)
    device = "cpu" if cell.chips == 1 else ["cpu"] * cell.chips
    logs = []
    result, bad = harness.run(bench, cell, seed, 0.01, trace, device=device,
                              t_start=time.perf_counter(), ref_device="cpu",
                              ref_budget=1 << 14, log=logs.append)
    return result, bad, logs


@pytest.fixture
def cuda_card():
    """Skips a test that needs the card when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
