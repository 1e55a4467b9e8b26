"""A cell and its files, found by name.

BENCHMARK.json at the root of the checkout lists the cells, configurations
and metrics.  Everything that belongs to one of them sits in a file of its
own under the benchmark's folder, so that a later change adds a cell, a
configuration, a length model or a per-layer metric by adding files:

    configs/<config>.json      the configuration (composition, length model,
                               algorithm, matrix, gaps, assumed, reduced)
    workloads/<cell>.json      the traffic: n, length range, long tail, pool
                               of sets, the check's sample sizes (the
                               cell's configuration and cards are its
                               entry in BENCHMARK.json)
    lengths/<model>.py         draw(rng, n, params, lo, hi) -> lengths
    metrics/<metric>.py        read(readings) -> number or None
    data/<name>.{txt,json}     frozen tables (matrices, compositions)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}: 1-64 of letters, digits, "
                         "'_', '.', '-', not starting with '.' or '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"bad unit {unit!r}")
    return unit


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


class Bench:
    """The benchmark at ``root`` (the checkout, holding BENCHMARK.json),
    its files in ``bench_dir``."""

    def __init__(self, root: Path, bench_dir: Path):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        path = self.dir / kind / (check_name(name) + suffix)
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        return path

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self._file(kind, name, ".json").read_text())

    def data(self, name: str, suffix: str) -> Path:
        return self._file("data", name, suffix)

    def module(self, kind: str, name: str):
        """The module ``<kind>/<name>.py``, loaded from its file (names may
        hold dots)."""
        path = self._file(kind, name, ".py")
        mod_name = f"portbench_{kind}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        e2e = [m for m in self.spec["end_to_end"] if mine(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if mine(m) and m["moves"] in reported]
        for m in e2e + per_layer:
            check_name(m["name"])
            check_unit(m["unit"])
        return Cell(name, int(entry["chips"]),
                    self.json("configs", entry["config"]),
                    self.json("workloads", name), e2e, per_layer)
