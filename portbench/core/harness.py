"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the library path of ``sequencealigner_tpu_torch.align``
job after job, in a closed loop of one client: each job builds a new
``Engine`` (every card the cell has), a full ``OutputStore`` and calls
``align_all`` on one set of the pool, cycling through it.  Set-up imports
the program, builds the pool from ``--seed``, and runs one warm-up job on
each set of the pool (the kernel library is built or loaded there).  The
window runs whole jobs until ``--seconds`` have passed and ends with the
last job.  Once it has closed, the device memory peak is read, the
program's state is freed and the reference scores what the jobs left in
their stores (core/check.py).

The result is one JSON line on standard output; everything else goes to
standard error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

from ..reference import matrix as ref_matrix
from . import check, hostwatch, profile, roofline, traffic

#: Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "sequencealigner_tpu")
PHASES = re.compile(r"(\S+)=([0-9.]+)ms")


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Program:
    """The system under test: the port's library path, and its counters."""

    KERNELS = ("align_tiles", "align_pairs", "align_grid")

    def __init__(self):
        from sequencealigner_tpu_torch.engine import Engine
        from sequencealigner_tpu_torch.io.input import SequenceSet
        from sequencealigner_tpu_torch.io.output import OutputStore
        from sequencealigner_tpu_torch.ops import cuda_dp

        self.Engine, self.SequenceSet = Engine, SequenceSet
        self.OutputStore, self.cuda_dp = OutputStore, cuda_dp

    def launches(self) -> dict:
        return {k: getattr(self.cuda_dp, k).launches for k in self.KERNELS}

    def launches_by_device(self) -> dict:
        out: dict = {}
        for k in self.KERNELS:
            for dev, c in getattr(self.cuda_dp, k).launches_by_device.items():
                out[dev] = out.get(dev, 0) + c
        return out


@dataclasses.dataclass
class Job:
    number: int
    set_index: int
    t0: float
    t1: float
    cells: int  # the harness's count, from the lengths it generated
    program_cells: int  # AlignStats.cells
    launches: dict  # kernel -> launches in this job
    by_device: dict  # device -> DP launches in this job
    phases: dict  # [phases] line, seconds (trace runs)
    host: dict  # hostwatch.host_delta over the job

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


def _delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def run_job(prog, algo, sub, gaps, seqset, ss, device, number, prof):
    """One job; returns (Job, its store)."""
    before, before_dev = prog.launches(), prog.launches_by_device()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        h0 = hostwatch.host_now()
        t0 = time.perf_counter()
        with prof.span("portbench.engine"):
            eng = prog.Engine(algo, sub, gaps, device=device)
        with prof.span("portbench.store"):
            store = prog.OutputStore(seqset.n, triangular=False, spill=False)
        with prof.span("portbench.align_all"):
            stats = eng.align_all(ss, store, progress=False)
        t1 = time.perf_counter()
        h1 = hostwatch.host_now()
    phases = {}
    for line in out.getvalue().splitlines():
        if line.startswith("[phases]"):
            phases = {k: float(v) / 1e3 for k, v in PHASES.findall(line)}
    job = Job(number, seqset.index, t0, t1,
              traffic.cells(seqset.lengths), int(stats.cells),
              _delta(prog.launches(), before),
              _delta(prog.launches_by_device(), before_dev), phases,
              hostwatch.host_delta(h0, h1))
    return job, store


def card_info() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return "; ".join(r.stdout.strip().splitlines()) or "not available"
    except (OSError, subprocess.SubprocessError):
        return "not available"


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers (metrics/<name>.py) read."""

    algo: str
    jobs: list
    cards: list
    trace: profile.TraceSummary | None
    bound_ms: object = roofline.bound_ms


def run(bench, cell, seed: int, seconds: float, trace: bool, *, device,
        t_start: float, ref_device, ref_budget: int = 1 << 24,
        log=print) -> tuple[dict, list]:
    """One run of ``cell``: the result's fields, and the forbidden modules
    the process held once its window had closed."""
    cfg, wl = cell.config, cell.workload
    if trace:
        os.environ["SEQALIGN_TPU_DEBUG_PHASES"] = "1"
    import torch

    prog = Program()
    first = device[0] if isinstance(device, (list, tuple)) else device
    cuda = str(first).startswith("cuda")
    algo = cfg["algorithm"]
    _, sub, lut = ref_matrix.load(bench.data(cfg["matrix"], ".txt"))
    # The program takes the reference aligner's (24, 24) matrix frame.
    frame = np.zeros((24, 24), np.int32)
    frame[: len(sub), : len(sub)] = sub
    g = cfg["gaps"]
    if algo == "nw":
        gaps = (-abs(int(g["gap"])), 0, 0)
        ref_gaps = (gaps[0], 0, 0)
    else:
        gaps = (0, -abs(int(g["open"])), -abs(int(g["extend"])))
        ref_gaps = (0, gaps[1], gaps[2])
    pool = traffic.make_pool(bench, cell, seed)
    sets = [prog.SequenceSet.from_list(s.seqs(), lut) for s in pool]
    cards = list(range(cell.chips))
    if cuda:
        log(f"cards: {card_info()}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{torch.cuda.device_count()} visible, {cell.chips} used")
    for s in pool:
        ls = s.lengths
        log(f"set {s.index}: {s.n} sequences of {int(ls.min())}-"
            f"{int(ls.max())} (median {float(np.median(ls))}, mean "
            f"{float(ls.mean()):.1f}), {traffic.cells(ls)} cells, long tail "
            f"{[int(ls[i]) for i in s.long]}")
    null = profile.Profiler(False)
    for s, ss in zip(pool, sets):
        job, store = run_job(prog, algo, frame, gaps, s, ss, device,
                             -1, null)
        del store
        log(f"warm-up on set {s.index}: {job.wall:.4f} s, launches "
            f"{job.launches}")
    log(f"kernel library build seconds {prog.cuda_dp.build_seconds}")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    jobs, samples, failed = [], [], 0
    prof = profile.Profiler(trace)
    watch = hostwatch.CardWatch(cuda)
    with watch, prof:
        with prof.span(profile.WINDOW):
            w0 = time.perf_counter()
            k = 0
            while not jobs or time.perf_counter() - w0 < seconds:
                s = pool[k % len(pool)]
                try:
                    job, store = run_job(prog, algo, frame, gaps, s,
                                         sets[s.index], device, k, prof)
                except Exception:
                    failed += 1
                    log(traceback.format_exc())
                    break
                with prof.span("portbench.read"):
                    sample = check.plan(s, wl["check"], seed, k)
                    check.read(sample, store.matrix, s.n)
                del store
                jobs.append(job)
                samples.append(sample)
                k += 1
            w1 = jobs[-1].t1 if jobs else time.perf_counter()
    window_s = w1 - w0
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
    bad = forbidden_modules()

    walls = [j.wall for j in jobs]
    for j in jobs:
        log(f"job {j.number} set {j.set_index}: wall {j.wall:.4f} s, cells "
            f"{j.cells} (program's AlignStats.cells {j.program_cells}), "
            f"launches {j.launches}, by device {j.by_device}, host {j.host}"
            f", card {watch.over(j.t0, j.t1)}"
            + (f", phases {j.phases}" if j.phases else ""))
    log(watch.summary())
    if jobs:
        log(f"jobs {len(jobs)} in {window_s:.4f} s; job wall median "
            f"{statistics.median(walls):.4f} s, p90 "
            f"{percentile(walls, 90):.4f} s, min {min(walls):.4f} s, max "
            f"{max(walls):.4f} s; cells per job, harness against program: "
            f"{sum(j.cells for j in jobs) / len(jobs):.1f} against "
            f"{sum(j.program_cells for j in jobs) / len(jobs):.1f}")

    summary = None
    if trace:
        t = time.perf_counter()
        summary = profile.summarize(prof.events, roofline.DP_KERNELS)
        prof.events = []
        log(f"trace read in {time.perf_counter() - t:.2f} s")
        if summary is not None:
            cells = sum(j.cells for j in jobs)
            log(f"traced window {summary.window_s:.4f} s; busy per card "
                f"{summary.busy_s}")
            for (card, k), ms in sorted(summary.kernel_ms_by_card.items()):
                log(f"card {card} {k}: device {ms:.3f} ms")
            for k, ms in summary.kernel_ms.items():
                if ms:
                    log(f"{k}: device {ms:.3f} ms over all cards")
            log(f"bound of the window's {cells} true cells "
                f"{roofline.bound_ms(cells, algo):.3f} ms ({algo}, "
                f"{roofline.peak_gcups(algo):.2f} GCUPS a card); cards "
                f"{card_info() if cuda else 'cpu'}")

    # The reference runs once the program's state is freed.
    del sets
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = {k: None for k in check.LIMITS}
    counts = {}
    if jobs:
        ref = check.reference_scores(samples, pool, lut, sub, algo, ref_gaps,
                                     device=ref_device, budget=ref_budget)
        counts = check.compare(samples, pool, ref)
        numbers = counts["numbers"]
        log(f"reference: {counts['distinct_pairs']} distinct pairs, "
            f"{counts['reference_cells']} cells, in "
            f"{time.perf_counter() - t:.2f} s; read {counts['read']}")
    correct = bool(jobs) and failed == 0 and check.verdict(numbers)

    metrics = {}
    if trace:
        readings = Readings(algo, jobs, cards, summary)
        for m in cell.per_layer:
            v = bench.module("metrics", m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    elif jobs:
        e2e = {
            "gcups": sum(j.cells for j in jobs) / window_s / 1e9,
            "job_p90_s": percentile(walls, 90),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(jobs) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = sum(summary.busy_s.get(c, 0.0)
                            for c in cards) / len(cards)
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    for k, lim in check.LIMITS.items():
        log(f"check {k} {numbers[k]} limit {lim}")
    return result, bad


def main(argv, *, root, t_start: float) -> int:
    import argparse

    from .spec import Bench

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    real_out = sys.stdout

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = Bench(root, root / "portbench")
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("portbench: no CUDA device: nothing to measure")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    device = ("cuda" if torch.cuda.device_count() == cell.chips
              else [f"cuda:{k}" for k in range(cell.chips)])
    with contextlib.redirect_stdout(sys.stderr):
        result, bad = run(bench, cell, args.seed, args.seconds,
                          bool(args.trace), device=device, t_start=t_start,
                          ref_device="cuda:0", log=log)
    return emit(result, bad, real_out, log)


def emit(result: dict, bad: list, out, log) -> int:
    """Prints the result line, unless the process held a forbidden module
    when its window closed or holds one now, after the readers, the trace
    and the reference have run."""
    bad = sorted(set(bad).union(forbidden_modules()))
    if bad:
        log(f"portbench: the run holds the modules {bad}, which it must "
            "not load")
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0
