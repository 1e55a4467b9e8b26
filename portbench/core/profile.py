"""The profiler window of a ``--trace 1`` run, and what is read from its
trace.

``torch.profiler`` records the device's kernels, copies and fills (CUPTI)
and the harness's own spans (``record_function``: ``portbench.window``
around the whole window, and per job ``portbench.engine``,
``portbench.store``, ``portbench.align_all``, ``portbench.read``).  The
trace is exported as Chrome trace JSON into the temporary directory, read
once and deleted.  From it:

- per card, the union of its operations' intervals inside the window
  (busy seconds), and the gaps between them, each named by the harness
  span the host was in at the gap's middle;
- per DP kernel, the summed device time over all cards;
- the operations that took most device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


class Profiler:
    """Context of the traced window; ``span(name)`` marks harness spans in
    it (a no-op when tracing is off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: list = []
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: dict  # card -> seconds
    kernel_ms: dict  # DP kernel symbol -> device ms summed over cards
    kernel_ms_by_card: dict  # (card, symbol) -> ms
    device_ops: list  # [[name, seconds]], most first
    idle_gaps: list  # [[name, seconds]], longest first


def summarize(events: list, dp_kernels, top: int = 10) -> TraceSummary | None:
    """What the readers need from a trace; None without a window span."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("ph") == "X"
        and str(e.get("name", "")).startswith("portbench.")
        and e["name"] != WINDOW)
    by_card: dict = {}
    op_s: dict = {}
    kernel_ms: dict = {k: 0.0 for k in dp_kernels}
    by_card_ms: dict = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s, t = max(s, w0), min(s + d, w1)
        if t <= s:
            continue
        card = int(e.get("args", {}).get("device", e.get("pid", 0)))
        by_card.setdefault(card, []).append((s, t))
        name = str(e.get("name", ""))
        op_s[name] = op_s.get(name, 0.0) + (t - s) / 1e6
        for k in dp_kernels:
            if k in name:
                kernel_ms[k] += (t - s) / 1e3
                by_card_ms[(card, k)] = by_card_ms.get((card, k), 0.0) + (
                    t - s) / 1e3
    busy, gaps = {}, []
    for card, iv in sorted(by_card.items()):
        merged = _merge(iv)
        busy[card] = sum(e - s for s, e in merged) / 1e6
        edges = [w0] + [x for se in merged for x in se] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                host = [nm for s, e, nm in spans if s <= mid <= e]
                what = host[-1][len("portbench."):] if host else "between spans"
                label = f"card {card} host in {what}" if len(by_card) > 1 \
                    else f"host in {what}"
                gaps.append([label, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n[:96], s] for n, s in op_s.items()), key=lambda o: -o[1])
    return TraceSummary((w1 - w0) / 1e6, busy, kernel_ms, by_card_ms,
                        ops[:top], gaps[:top])
