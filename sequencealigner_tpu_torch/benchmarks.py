# Port of sequencealigner_tpu/benchmarks.py: only imports, source paths and the docstring differ (dedupe: ROADMAP A15).
"""-B benchmark subsystem: per-phase accumulating wall timers + summary.

Parity with the reference's benchmark UX (reference src/util/benchmark.c):
phases input / filter / align / output, each printing "<Name>: N.NNN sec" when
it completes, and a final "Performance Summary" with per-phase percentages,
total, and alignments-per-second (benchmark.c:50-64).  An addition per
SURVEY.md §5: a GCUPS readout (DP cell updates per second).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from . import ui

enabled = False
_times = {"input": 0.0, "filter": 0.0, "align": 0.0, "output": 0.0}
_names = {"input": "Input", "filter": "Filtering", "align": "Alignment", "output": "Output"}
_extra = {"cells": 0}


def reset() -> None:
    for k in _times:
        _times[k] = 0.0
    _extra["cells"] = 0


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if enabled:
            _times[name] += time.perf_counter() - t0


def phase_print(name: str) -> None:
    if enabled:
        ui.pinfo("%s: %.3f sec", _names[name], _times[name])


def note_cells(cells: int) -> None:
    _extra["cells"] += int(cells)


def total_print(alignments: float) -> None:
    if not enabled:
        return
    total = sum(_times.values())
    ui.psection("Performance Summary")
    ui.pinfo("Timing breakdown:")
    for key in ("input", "filter", "align", "output"):
        if key in ("filter", "output") and _times[key] == 0.0:
            continue
        pct = (_times[key] / total * 100) if total else 0.0
        ui.pinfom("%s: %.3f sec (%.1f%%)", _names[key], _times[key], pct)
    ui.pinfol("Total: %.3f sec", total)
    if _times["align"] > 0:
        ui.pinfo("Alignments per second: %.2f", alignments / _times["align"])
        if _extra["cells"]:
            ui.pinfo("GCUPS: %.3f", _extra["cells"] / _times["align"] / 1e9)
