"""Device-time profile of the engine on the card, per kernel.

    python -m sequencealigner_tpu_torch.tools.profile_main [--seed 1]
        [--rounds 2] [--set main|wide|long|tiles|short] [--cost PAIRS]

Builds a set from ``--seed`` and aligns it into a full store, after one
warm-up run per engine, ``--rounds`` times.  Every run is recorded with
``torch.profiler`` and the engine's spans (trace.py) and prints, per
kernel, its device milliseconds, its launches, its bound and its share of
the bound, and the card's idle time split by what the host was doing at
each idle gap's middle: the main thread's innermost span and the
flusher's (``-`` for none).  Each is followed by one run that is not
profiled, for the wall time; all the matrices must be equal.  It also
prints nvcc's register report, and the registers and resident blocks per
SM of the tile kernel and of both forms of the per-pair kernel.  With
``--cost PAIRS`` it then times PAIRS pairs of jobs (a new Engine and
store each, as a library caller makes them), one with
SEQALIGN_TPU_DEBUG_PHASES unset and one with it set, in turns that swap
which goes first, and prints the median job wall both ways.
The sets (chip_smoke.py's, then two of other shapes):

  main  4096 proteins of 50-500 residues, GA BLOSUM62 open 10 extend 1,
        in turns under the tiles-v2 and the linear-v1 schedule
        (SEQALIGN_TPU_OUTER=0);
  wide  512 proteins of 50-500 residues, GA 10/1 under BLOSUM62 x 20
        (int32 scores: the linear-v1 route);
  long  128 DNA sequences of 3,000-9,000 nt, SW NUC44 10/1 (buckets beyond
        W_MAX: the linear-v1 route);
  tiles 4096 proteins of 10-1,023 residues, log-normal lengths of median
        300 (sigma 0.6, redrawn outside the range), GA BLOSUM62 10/1;
  short 2048 peptides of 8-50 residues, GA BLOSUM62 10/1.

The bound of a kernel is the true DP cells it scores (sum of l1 * l2 over
its pairs) times the fewest SM clocks a cell needs, over 132 SMs x 1.98 GHz
(H100 SXM).  A cell's instructions (NW 3, GA 6, SW 6.5) split over two
pipes of 64 a clock per SM: DPX and min/max on the ALU pipe (NW 2, GA 3,
SW 3.5), the adds on the FMA pipe (``IMAD.IADD``), and all of them issue at
128 a clock per SM; the clocks are the largest of the three (tools/
dpx_rate.py measures the pipes on the card).

The package is imported by its absolute name, so the same file can profile
another checkout of it: ``PYTHONPATH=<checkout> python <this file>``.  Two
checkouts are compared in one call by running it in turns, A B B A.
Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from sequencealigner_tpu_torch import engine, matrices, trace
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.ops import cuda_dp
from sequencealigner_tpu_torch.scheduler import Schedule

RESIDUES = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
#: Fewest instructions a DP cell issues: NW the diagonal add and two add-max
#: (__viaddmax_s32); GA three adds, two add-max and one three-way max; SW
#: GA's with the zero floor folded into the max, and the running best taken
#: by one three-way max per two cells.
OPS_PER_CELL = {"nw": 3, "ga": 6, "sw": 6.5}
#: Of those, the DPX and min/max ones, on the ALU pipe; the rest are adds,
#: which can issue on the FMA pipe.
ALU_OPS_PER_CELL = {"nw": 2, "ga": 3, "sw": 3.5}
#: Per SM and clock: instructions issued (4 schedulers x 32 lanes) and the
#: ALU and FMA pipes' integer rate each (DPX at 62-63 a clock measured by
#: tools/dpx_rate.py on an H100).
ISSUE, PIPE = 128, 64
#: SMs and peak SM clock of an H100 SXM.
SMS, CLOCK_HZ = 132, 1.98e9
KERNELS = {"align_tiles": "tiles_kernel", "align_pairs": "pairs_kernel",
           "align_grid": "grid_kernel"}


def bound_ms(cells: int, algo: str) -> float:
    """Least device milliseconds for ``cells`` true DP cells of ``algo``."""
    ops, alu = OPS_PER_CELL[algo], ALU_OPS_PER_CELL[algo]
    clocks = max(ops / ISSUE, alu / PIPE, (ops - alu) / PIPE)
    return cells * clocks / (SMS * CLOCK_HZ) * 1e3


def proteins(rng, n: int, lo: int, hi: int) -> list:
    return [rng.choice(RESIDUES, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def lognormal_proteins(rng, n: int, median: float, sigma: float, lo: int,
                       hi: int) -> list:
    """``n`` proteins of log-normal lengths, each drawn again until it lies
    in [lo, hi]."""
    lens = np.zeros(n, np.int64)
    bad = np.ones(n, bool)
    while bad.any():
        lens[bad] = np.rint(rng.lognormal(np.log(median), sigma, bad.sum()))
        bad = (lens < lo) | (lens > hi)
    return [rng.choice(RESIDUES, int(k)) for k in lens]


@contextlib.contextmanager
def recording(on: bool):
    """SEQALIGN_TPU_DEBUG_PHASES set (or unset) inside, as it was after;
    the engine's ``[phases]`` lines are dropped."""
    old = os.environ.pop("SEQALIGN_TPU_DEBUG_PHASES", None)
    if on:
        os.environ["SEQALIGN_TPU_DEBUG_PHASES"] = "1"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield
    finally:
        os.environ.pop("SEQALIGN_TPU_DEBUG_PHASES", None)
        if old is not None:
            os.environ["SEQALIGN_TPU_DEBUG_PHASES"] = old


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_split(events: list) -> dict:
    """Seconds the card ran nothing inside each ``engine.align_all`` of a
    trace that holds the engine's spans (trace.add_chrome_events), by what
    the host was doing at each idle gap's middle: ``"<main> / <flusher>"``,
    each thread's innermost span there, ``engine.`` dropped, ``-`` for
    none."""
    spans = [e for e in events if e.get("cat") == "engine"
             and e.get("ph") == "X"]
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in events
                  if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")

    def inner(thread: str, t: float) -> str:
        at = [e for e in spans if e["args"]["thread"] == thread
              and e["ts"] <= t <= e["ts"] + e["dur"]]
        if not at:
            return "-"
        # The latest start, then the shortest: the innermost of nested spans.
        span = max(at, key=lambda e: (e["ts"], -e["dur"]))
        return span["name"].removeprefix("engine.")

    out: dict = {}
    for top in (e for e in spans if e["name"] == trace.TOP):
        w0, w1 = top["ts"], top["ts"] + top["dur"]
        edge = w0
        gaps = []
        for s, e in busy:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if w1 > edge:
            gaps.append((edge, w1))
        for a, b in gaps:
            mid = (a + b) / 2
            label = f"{inner('main', mid)} / {inner('flusher', mid)}"
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def tile_cells(lengths) -> int:
    """True cells of the tile stream (the rest of a tiles-v2 run's cells
    are the diagonal remainder's, through the per-pair kernel)."""
    sched = Schedule.build(np.asarray(lengths))
    return sum(t.cells for a, b in sched.combos() for t in sched.tiles(a, b))


def schedule_bounds(lengths, algo: str) -> dict:
    """Per schedule and kernel, the bound of one run over ``lengths``."""
    total = Schedule.build(np.asarray(lengths)).total_cells()
    tcells = tile_cells(lengths)
    return {
        "tiles-v2": {"align_tiles": bound_ms(tcells, algo),
                     "align_pairs": bound_ms(total - tcells, algo)},
        "linear-v1": {"align_pairs": bound_ms(total, algo)},
    }


def linear_engine(algo, sub, gaps, dev):
    """An Engine built under SEQALIGN_TPU_OUTER=0 (read at construction)."""
    old = os.environ.get("SEQALIGN_TPU_OUTER")
    os.environ["SEQALIGN_TPU_OUTER"] = "0"
    try:
        return engine.Engine(algo, sub, gaps, device=dev)
    finally:
        if old is None:
            del os.environ["SEQALIGN_TPU_OUTER"]
        else:
            os.environ["SEQALIGN_TPU_OUTER"] = old


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def profiled_run(eng, ss: SequenceSet) -> dict:
    """One align_all of ``ss`` into a square store under torch.profiler,
    recording the engine's spans: wall seconds, GCUPS, the matrix, per
    kernel (wrapper name) device ms and launches counted from zero just
    before the run, the card's idle split (idle_split), the run's flushes
    by cause and its upload and score-copy bytes."""
    from torch.profiler import ProfilerActivity, profile

    store = OutputStore(ss.num, triangular=False, spill=False)
    for k in KERNELS:
        getattr(cuda_dp, k).launches = 0
    torch.cuda.synchronize()
    with recording(True), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.align_all(ss, store, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    run, = (r for r in trace.runs() if r.top.t0 >= t0)
    trace.add_chrome_events(events, [run])
    launches = {k: getattr(cuda_dp, k).launches for k in KERNELS}
    ms = dict.fromkeys(KERNELS, 0.0)
    for evt in prof.key_averages():
        for k, sym in KERNELS.items():
            if sym in evt.key:
                ms[k] += _device_us(evt) / 1e3
    return {"wall": wall, "gcups": stats.gcups, "cells": stats.cells,
            "ms": ms, "launches": launches, "idle": idle_split(events),
            "flushes": dict(sorted(run.causes.items())),
            "spans": len(run.spans),
            "h2d_bytes": sum(s.attrs["h2d_bytes"]
                             for s in run.named("engine.pack")),
            "d2h_bytes": sum(s.attrs["d2h_bytes"]
                             for s in run.named("engine.flush")),
            "matrix": np.asarray(store.matrix).reshape(ss.num, ss.num)}


def timed_run(eng, ss: SequenceSet) -> dict:
    """One align_all of ``ss`` into a square store, not profiled: wall
    seconds to the filled store and GCUPS."""
    store = OutputStore(ss.num, triangular=False, spill=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False)
    wall = time.perf_counter() - t0
    return {"wall": wall, "gcups": stats.cells / wall / 1e9,
            "matrix": np.asarray(store.matrix).reshape(ss.num, ss.num)}


def cost_turns(make_engine, ss: SequenceSet, pairs: int, log=print) -> dict:
    """``pairs`` pairs of jobs on ``ss``, each a new engine from
    ``make_engine()``, a new square store and align_all, timed to its
    return: one with recording off and one with it on, the first of each
    pair swapping.  Returns and logs the median wall both ways and the
    quartiles of the pairs' ratios (on over off: neighbours in time share
    the host's drift)."""
    walls: dict = {False: [], True: []}
    for k in range(pairs):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            with recording(on):
                t0 = time.perf_counter()
                eng = make_engine()
                store = OutputStore(ss.num, triangular=False, spill=False)
                eng.align_all(ss, store, progress=False)
                walls[on].append(time.perf_counter() - t0)
            del eng, store
    off, on = (statistics.median(walls[x]) for x in (False, True))
    ratios = [b / a for a, b in zip(walls[False], walls[True])]
    q = statistics.quantiles(ratios, n=4) if pairs > 1 else ratios * 3
    log(f"recording cost: {pairs} jobs each way, median job wall "
        f"{off:.4f} s unset, {on:.4f} s set ({(on / off - 1) * 100:+.2f}%); "
        f"pairs' ratio set/unset quartiles {q[0]:.4f} {q[1]:.4f} "
        f"{q[2]:.4f}; walls unset {[round(w, 4) for w in walls[False]]}, "
        f"set {[round(w, 4) for w in walls[True]]}")
    return {"off": off, "on": on, "ratios": q, "walls": walls}


def turns(engines: dict, ss: SequenceSet, bounds: dict, rounds: int,
          log=print, tag=lambda label: "") -> dict:
    """``rounds`` rounds of, for each engine in turn, one profiled run and
    one timed run of ``ss`` (after one warm-up run each); every matrix must
    equal the first.  Logs each run and, per round, the tile kernel's
    device time over linear-v1's per-pair kernel time; returns {label:
    [profiled results]}."""
    for eng in engines.values():  # uploads, allocator, build
        eng.align_all(ss, None, progress=False)
    prof: dict = {label: [] for label in engines}
    ref = None
    for k in range(rounds):
        for label, eng in engines.items():
            r = profiled_run(eng, ss)
            report(f"{tag(label)}profiled {label} {k}", r, bounds[label], log)
            t = timed_run(eng, ss)
            log(f"{tag(label)}timed {label} {k}: wall {t['wall']:.4f} s, "
                f"{t['gcups']:.2f} GCUPS (not profiled)")
            for m in (r["matrix"], t["matrix"]):
                if ref is None:
                    ref = m
                elif not np.array_equal(ref, m):
                    raise AssertionError(f"{label} round {k}: matrix differs")
            prof[label].append(r)
    if {"tiles-v2", "linear-v1"} <= set(prof):
        ratio = [t["ms"]["align_tiles"] / lv["ms"]["align_pairs"]
                 for t, lv in zip(prof["tiles-v2"], prof["linear-v1"])]
        log(f"{tag('tiles-v2')}tiles_kernel device ms / linear-v1 "
            "pairs_kernel device ms: " + ", ".join(f"{x:.3f}" for x in ratio))
    return prof


def registers(kernel: str) -> dict:
    """Registers per thread of each instance of ``kernel`` (tiles_kernel,
    pairs_kernel or grid_kernel) from nvcc's report of the build (empty
    when the library was built by another process), keyed by algo; for
    pairs_kernel by (algo, split form)."""
    regs, key = {}, None
    pat = re.compile(kernel + r"ILi(\d)E(?:Lb(\d)E)?")
    for ln in cuda_dp.build_log.splitlines():
        if "Compiling entry" in ln:
            m = pat.search(ln)
            key = None
            if m:
                algo = ("nw", "ga", "sw")[int(m.group(1))]
                key = algo if m.group(2) is None else (algo, m.group(2) == "1")
        elif key and "registers" in ln:
            regs[key] = int(ln.split("Used")[1].split()[0])
            key = None
    return regs


def occupancy_lines() -> list:
    """Registers and resident blocks per SM of both forms of the tile
    kernel (int32 and 16-bit) and of the per-pair kernel (one-lane and
    split), per algo, on the current device."""
    pairs = registers("pairs_kernel")
    algos = ("nw", "ga", "sw")
    return [
        f"{name} registers per thread " + ", ".join(
            f"{a} {registers(name).get(a)}" for a in algos) + "; resident "
        "blocks per SM " + ", ".join(
            f"{a} {cuda_dp.tiles_resident(a, dp16)}" for a in algos)
        for name, dp16 in (("tiles_kernel", False), ("tiles_kernel16", True))
    ] + [
        f"pairs_kernel {form} registers per thread " + ", ".join(
            f"{a} {pairs.get((a, split))}" for a in algos) + "; resident "
        "blocks per SM " + ", ".join(
            f"{a} {cuda_dp.pairs_resident(a, split)}" for a in algos)
        for form, split in (("one-lane", False), ("split", True))
    ]


def report(label: str, r: dict, bounds: dict, log=print) -> None:
    log(f"{label}: wall {r['wall']:.4f} s, {r['cells']} cells, "
        f"{r['gcups']:.2f} GCUPS, launches {r['launches']}")
    for k, ms in r["ms"].items():
        if not r["launches"][k]:
            continue
        b = bounds.get(k, 0.0)
        share = b / ms if ms else 0.0
        log(f"{label}: {k:11s} device {ms:.3f} ms in {r['launches'][k]} "
            f"launches ({ms / r['launches'][k]:.3f} ms each), bound "
            f"{b:.3f} ms, share of bound {share:.3f}")
    idle = r.get("idle")
    if idle:
        log(f"{label}: {r['spans']} spans, flushes by cause "
            f"{r['flushes']}, uploads {r['h2d_bytes']} bytes, score copies "
            f"{r['d2h_bytes']} bytes")
        total = sum(idle.values())
        log(f"{label}: card idle {total * 1e3:.3f} ms, by host main / "
            "flusher: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms ({v / total:.3f})"
                for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:8]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--set", choices=("main", "wide", "long", "tiles",
                                      "short"), default="main")
    ap.add_argument("--cost", type=int, default=0, metavar="PAIRS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    gaps = (0, -10, -1)
    if args.set == "long":
        algo, name = "sw", "nuc44"
        M = matrices.get(name)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        raw = [rng.choice(acgt, int(rng.integers(3000, 9001)))
               for _ in range(128)]
    else:
        algo, name = "ga", "blosum62"
        M = matrices.get(name)
        if args.set == "tiles":
            raw = lognormal_proteins(rng, 4096, 300, 0.6, 10, 1023)
        elif args.set == "short":
            raw = proteins(rng, 2048, 8, 50)
        else:
            raw = proteins(rng, 4096 if args.set == "main" else 512, 50, 500)
    matrix = M.matrix
    if args.set == "wide":
        matrix, name = M.matrix.astype(np.int64) * 20, "blosum62 x 20"
    ss = SequenceSet.from_list(raw, M.lut)
    if args.set == "main":
        engines = {"tiles-v2": engine.Engine(algo, matrix, gaps, device=dev),
                   "linear-v1": linear_engine(algo, matrix, gaps, dev)}
    elif args.set in ("tiles", "short"):
        engines = {"tiles-v2": engine.Engine(algo, matrix, gaps, device=dev)}
    else:  # the engine takes linear-v1 for these sets by itself
        engines = {"linear-v1": engine.Engine(algo, matrix, gaps,
                                              device=dev)}
    cuda_dp.load_library()
    for ln in cuda_dp.build_log.splitlines():  # nvcc's -Xptxas -v report
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"ptxas: {ln.strip()}")
    for line in occupancy_lines():
        print(line)
    bounds = schedule_bounds(ss.lengths, algo)
    print(f"set {args.set}: {ss.num} sequences of {min(ss.lengths)}-"
          f"{max(ss.lengths)} (seed {args.seed}), {algo.upper()} "
          f"{name} {-gaps[1]}/{-gaps[2]}, "
          f"{Schedule.build(ss.lengths).total_cells()} cells; bounds "
          f"{bounds}; {torch.cuda.get_device_name(0)}")
    turns(engines, ss, bounds, args.rounds)
    print("matrices of every run equal")
    if args.cost:
        cost_turns(functools.partial(engine.Engine, algo, matrix, gaps,
                                     device=dev), ss, args.cost)
    return 0


if __name__ == "__main__":
    sys.exit(main())
