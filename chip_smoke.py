#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (sequencealigner_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0]

It builds the CUDA kernels from csrc/ (into the git-ignored
sequencealigner_tpu_torch/_build/, unless SEQALIGN_TPU_CACHE names another
build directory) and goes through twelve phases, each printing its own
lines; any failure raises, so the exit code is non-zero and no result line
is printed.

  (a) the card (nvidia-smi name and power limit), torch, the kernel build;
  (b) each kernel against its plain PyTorch version on the card (the tile
      kernel in both forms, int32 and 16-bit, each with its own ms), NW/GA/SW,
      BLOSUM62, at the main path's shapes (single-band edge 64, multi-band
      edge 160, a cross-bucket 256 x 96 combo, diagonal-remainder blocks
      with tail slots, and a 512 x 320 combo of 700 x 400 rows in length
      order whose 26 tiles go in one launch as the engine groups them, so
      the tile kernel's work counter and persistent loop run; random
      lengths including 1 and the edge, dummy descriptor rows), exact
      equality, plus CUDA-event timings of both beside each call's bound;
      then the per-pair kernel alone at shapes that, with those, launch
      every lanes-per-pair G the layout rule can choose (cuda_dp.
      pair_lanes: 1 to 32): 262,144 pairs of edge 64, 4,096 of edge 160,
      2,048 of edge 512, and 64 and 512 pairs of lengths up to 3,000 among
      which every pair of the stripe-boundary lengths l1 in {1, 3, 4, 5,
      40} and l2 in {1, 31, 32, 33, 255, 256, 257, 1023, 1024, 1025}; each
      logs its G;
  (c) the library align() on examples/peptides.fasta for NW/GA/SW against
      the NumPy oracle on every pair, and the seqalign-torch CLI (-W);
  (d) the main path at a size users run: 4096 proteins (lengths 50-500,
      20 residues, from --seed), GA BLOSUM62 open 10 extend 1, into a full
      OutputStore; wall time, pairs, cells and GCUPS; 32 sampled pairs
      against the oracle and 4096 against the plain version on the card;
      both kernels' launch counts, which are zeroed just before this run.
      Then the same at bench.py's shape (1024 proteins, lengths 24-64);
  (e) the superblock entry points: the grid kernel and the inline mode
      against the grid kernel's plain version for NW/GA/SW at (Lc, Lk) =
      (21, 13), (80, 70) and (70, 40) with S = 3, and the grid kernel at
      B = 256, 100, 48, 200 and 130 lanes a row, so that every copy form
      (cuda_dp.grid_form) is launched, each launch's form, stages, shared
      memory, registers and resident blocks logged; then align_superblock
      at full size (GA, 256 x 256, S = pick_S = 256: 32,768 pairs on a 2
      GiB int8 grid) in grid and inline mode, its launch counts zeroed just
      before, both results against plain, with CUDA-event times of
      build_stream, the grid kernel and plain, and the kernel's share of
      its bound (the 32-byte sectors of the grid that the lengths need:
      tools/profile_kernels.grid_bound) and of the whole grid's bytes;
      then tools/fuzz_hw with 8 trials;
  (f) the linear-v1 schedule (SEQALIGN_TPU_OUTER=0) on (d)'s 4096-protein
      set: the matrix must equal (d)'s tiles-v2 matrix, with no tile launch
      and some per-pair launches; wall time, pairs, cells and GCUPS.  Then
      (d)'s tiles-v2 run and this linear-v1 run in turns under
      torch.profiler, twice: per kernel device ms, launches, bound and
      share of the bound (tools/profile_main), the tile kernel's device
      time over linear-v1's per-pair kernel time, and the registers and
      resident blocks per SM of the tile kernel and of both forms (one
      lane a pair, and G lanes a pair) of the per-pair kernel;
  (g) long and wide inputs through the linear-v1 route: 128 DNA sequences
      of 3,000-9,000 nt (NUC44, SW 10/1; buckets beyond W_MAX), 64 sampled
      pairs against plain, one more run under torch.profiler for the
      per-pair kernel's device ms, its G, its bound and its share of the
      bound, plus align() and the CLI on three sequences over
      4096 nt; and 512 proteins (lengths 50-500) under BLOSUM62 x 20 (GA
      10/1, |score| up to 220), 256 sampled pairs against plain; GCUPS of
      both;
  (h) the -f similarity filter on the card: 16,384 proteins of 50-500
      from --seed, of which 2,048 are near-copies of an earlier original
      (at most 5% of positions substituted) and 256 prefix truncations of
      one, at threshold 0.9: ``kept`` must be the originals exactly; the
      same function on the CPU must equal the card on a 2,048-sequence
      subset; seconds of both; then seqalign-torch -f 0.9 on that subset;
  (i) checkpoint/resume on the card: (d)'s main set under tiles-v2 and
      under linear-v1, each cut by limit_pairs at half the pairs into a
      score store pre-filled with a sentinel (journal commits at every
      flush), then resumed: the matrix must equal (d)'s, pairs plus
      resumed pairs N(N-1)/2, some resumed, and the resumed run must
      launch its kernels; seconds of each run.  Then seqalign-torch -k
      twice on 300 proteins (the second run prints "Resuming" and writes
      the same output), and once with -t DIR, whose trace must name the
      tile kernel's CUDA symbol.  Every CLI run fails its phase if it
      prints "No CUDA device found";
  (j) several devices on one host: (d)'s main set under tiles-v2 and
      under linear-v1 on device=["cuda:0", "cuda:0"] (two entries, each
      with its own stream, on the one card), then on every card when
      there are two or more (else a line says that run was not possible):
      each matrix must equal (d)'s, every entry must have been sent
      launches and every card must have launched (launches_by_device);
      wall time, launch groups and cells per entry beside a one-device run
      in the same phase.  Then a one-device run cut at half the pairs with
      a journal, resumed on the two entries (matrix == (d)'s, pairs
      resumed), and entry.dryrun_multidevice on the two entries;
  (k) two hosts on one machine: two processes of this script joined over
      gloo through SEQALIGN_TPU_COORDINATOR=127.0.0.1:<free port>,
      SEQALIGN_TPU_NUM_PROCESSES=2 and SEQALIGN_TPU_PROCESS_ID=0/1, both
      on cuda:0.  First Engine.align_all(partition=, merger=TripletMerger)
      on the main set: both stores must equal (d)'s matrix; each host's
      pairs, cells, merges, merge seconds and bytes, and the larger share
      of cells over the mean.  Then seqalign-torch -k as two hosts on 300
      proteins: host 0's output must equal a one-process run's, and the
      journals must be run.ckpt.h0 and .h1.  Every child has a deadline;
      a child that fails or times out fails the phase;
  (l) the phase breakdown and the build cache: (d)'s main set under
      tiles-v2 and under linear-v1, each on a new engine, once with
      SEQALIGN_TPU_DEBUG_PHASES unset and once set (a new SequenceSet, so
      both pack their buckets as a CLI run does): each matrix must equal
      (d)'s, the unset run prints no [phases] line and the set run exactly
      one, with the four keys of the reference (schedule+dispatch,
      flush.materialize, flush.fetch_wait, final_flush), none negative;
      the line is printed beside both walls and the launches.  Then fresh
      processes load the kernel library with SEQALIGN_TPU_CACHE set to a
      new temporary directory: the first builds into it (nvcc seconds > 0)
      and adds nothing under the package, the second loads what the first
      built (nvcc seconds 0); one under "0" builds into a private
      directory that is gone after it exits.

The second-to-last lines are the kernels' JSON record and the card's
nvidia-smi line; the last line is the JSON result.  It needs no network and
no JAX, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "sequencealigner_tpu_torch/csrc/align_dp.cu"
REPLACES = {
    "align_tiles": "sequencealigner_tpu/ops/pallas_dp.py:791",
    "align_pairs": "sequencealigner_tpu/ops/pallas_dp.py:724",
    "align_grid": "sequencealigner_tpu/ops/pallas_dp.py:681",
}
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -10, -1))]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def bucket(rng, count, edge, in_order=False):
    """(count, edge) codes and lengths (1 and the edge among them); with
    in_order, rows by ascending length, as the engine packs a bucket."""
    from sequencealigner_tpu_torch.ops.geometry import PAD

    lens = rng.integers(1, edge + 1, count).astype(np.int32)
    if in_order:
        lens.sort()
    lens[0], lens[-1] = 1, edge
    mat = np.full((count, edge), PAD, np.int8)
    for i, ln in enumerate(lens):
        mat[i, :ln] = rng.integers(0, 20, ln)
    return mat, lens


def tile_call_cells(desc, cwords, klens) -> int:
    """True DP cells of one align_tiles call: per tile, the sum of its
    c-row lengths times the sum of its k-lane lengths."""
    c = np.concatenate([[0], np.cumsum(cwords[:, 0], dtype=np.int64)])
    k = np.concatenate([[0], np.cumsum(klens[0], dtype=np.int64)])
    return int(sum((c[c0 + 128] - c[c0]) * (k[kt * 128 + 128] - k[kt * 128])
                   for c0, kt in desc))


def bound(cells: int, tensors, algo: str = "ga"):
    """(ms, what bounds it): the least time of a call on an H100, the larger
    of its operations (true cells at the fewest SM clocks a cell needs,
    tools/profile_main.bound_ms) and its bytes (each input read once, each
    output written once, at 3.35 TB/s)."""
    from sequencealigner_tpu_torch.tools.profile_main import bound_ms

    ops = bound_ms(cells, algo)
    mem = sum(t.numel() * t.element_size() for t in tensors) / 3.35e12 * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


#: Stripe-boundary lengths of the per-pair kernel's split form: l2 (rows)
#: at KB = 32 and G * KB +- 1, l1 (columns) around a group of four.
BOUNDARY_L1 = (1, 3, 4, 5, 40)
BOUNDARY_L2 = (1, 31, 32, 33, 255, 256, 257, 1023, 1024, 1025)


def pair_lanes(n: int, edge_k: int, algo: str) -> int:
    """The lanes per pair (G) align_pairs takes for n pairs whose k bucket
    has ``edge_k`` rows, on this card."""
    from sequencealigner_tpu_torch.ops import cuda_dp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return cuda_dp.pair_lanes(n, edge_k, sms,
                              cuda_dp.pairs_resident(algo, False))


def long_pairs(rng, n, edge=3000):
    """n pairs of lengths up to ``edge``: first every (l1, l2) pair of the
    boundary lengths, then random rows."""
    from sequencealigner_tpu_torch.ops.geometry import PAD

    mats = []
    for fixed in (BOUNDARY_L1, BOUNDARY_L2):
        lens = rng.integers(1, edge + 1, max(n, len(fixed))).astype(np.int32)
        lens[: len(fixed)] = fixed
        mat = np.full((len(lens), edge), PAD, np.int8)
        for i, ln in enumerate(lens):
            mat[i, :ln] = rng.integers(0, 20, ln)
        mats.append((mat, lens))
    nb = len(BOUNDARY_L1) * len(BOUNDARY_L2)
    rc = rng.integers(0, len(mats[0][1]), n).astype(np.int32)
    rk = rng.integers(0, len(mats[1][1]), n).astype(np.int32)
    rc[:nb] = np.repeat(np.arange(len(BOUNDARY_L1)), len(BOUNDARY_L2))
    rk[:nb] = np.tile(np.arange(len(BOUNDARY_L2)), len(BOUNDARY_L1))
    (cm, cl), (km, kl) = mats
    return cm, km, rc, rk, cl, kl


def phase_b(rng, dev, M):
    """Kernel vs plain at the main path's shapes, then the per-pair kernel
    at shapes that launch every G; returns the worst error per kernel and,
    per (kernel, shape), the GA kernel and plain ms and the call's bound."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.ops import cuda_dp, geometry, torch_dp
    from sequencealigner_tpu_torch.scheduler import TRI_W

    shapes = [("single-band 64", 64, 64, 300, 200),
              ("multi-band 160", 160, 160, 300, 200),
              ("cross 256x96", 256, 96, 300, 200),
              ("diag-tail 128", 128, 128, 300, 200),
              ("multi-tile 512x320", 512, 320, 700, 400)]
    err = {"align_tiles": 0, "align_tiles16": 0, "align_pairs": 0}
    times = {}
    lanes_seen = set()
    for label, Lc, Lk, nc, nk in shapes:
        multi = label.startswith("multi-tile")
        cmat, clens = bucket(rng, nc, Lc, in_order=multi)
        kmat, klens = bucket(rng, nk, Lk, in_order=multi)
        cw = geometry.pack_bucket_outer(cmat, clens, Lc)[0]
        _, kT, kl = geometry.pack_bucket_outer(kmat, klens, Lk)
        dummy = cw.shape[0] - geometry.S_TILE
        nkt = -(-nk // geometry.LANE)
        desc = [(c0, kt) for kt in range(nkt) for c0 in range(0, nc, 128)]
        desc = np.array(desc + [(dummy, 0), (dummy, 1)], np.int32)
        if multi:
            # One launch as the engine groups a combo of this many tiles.
            cap = engine.FLUSH_PAIRS // (geometry.S_TILE * geometry.LANE)
            if cuda_dp.tiles_per_launch(len(desc), cap) < len(desc):
                raise AssertionError(f"(b) {label}: not one launch")
        targs = [torch.from_numpy(a).to(dev) for a in (desc, cw, kT, kl)]
        if Lc == Lk:  # the same-bucket diagonal remainder, tail window
            n_slots = 3 * TRI_W  # 300 rows: windows of 128, 128, 44
            lin = torch.arange(1 << (n_slots - 1).bit_length(), device=dev)
            rc, rk = engine._diag_rows(lin, n_slots, 300)
            mats = (cmat, cmat, clens, clens)
        else:
            rc = torch.from_numpy(rng.integers(0, nc, 8192).astype(np.int32))
            rk = torch.from_numpy(rng.integers(0, nk, 8192).astype(np.int32))
            rc, rk = rc.to(dev), rk.to(dev)
            mats = (cmat, kmat, clens, klens)
        mc, mk, lc, lk = (torch.from_numpy(a).to(dev) for a in mats)
        pargs = (mc, mk, rc, rk, lc, lk)
        cells = {"align_tiles": tile_call_cells(desc, cw, kl),
                 "align_tiles16": tile_call_cells(desc, cw, kl),
                 "align_pairs": int((lc[rc.long()].long()
                                     * lk[rk.long()].long()).sum())}
        for algo, gaps in ALGO_GAPS:
            sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
            for name, kern, plain, args in (
                ("align_tiles", cuda_dp.align_tiles,
                 torch_dp.align_tiles_plain, targs),
                ("align_tiles16", functools.partial(cuda_dp.align_tiles,
                                                    dp16=True),
                 torch_dp.align_tiles_plain, targs),
                ("align_pairs", cuda_dp.align_pairs,
                 torch_dp.align_pairs_plain, pargs),
            ):
                G = (pair_lanes(rc.shape[0], mk.shape[1], algo)
                     if name == "align_pairs" else None)
                check_call(name, kern, plain, args, sub, g, algo, label,
                           cells[name], err, times, G)
                if G:
                    lanes_seen.add(G)
            log(f"(b) {label:18s} {algo}: both kernels, and align_tiles' "
                f"16-bit form, == plain (exact), {len(desc)} tiles in one "
                "align_tiles launch")
    lone = [("G=1 262144x64", 262144, 64), ("4096x160", 4096, 160),
            ("2048x512", 2048, 512),
            ("64 up to 3000", 64, None), ("512 up to 3000", 512, None)]
    for label, n, edge in lone:
        if edge is None:
            arrays = long_pairs(rng, n)
        else:
            cmat, clens = bucket(rng, 600, edge)
            kmat, klens = bucket(rng, 500, edge)
            arrays = (cmat, kmat, rng.integers(0, 600, n).astype(np.int32),
                      rng.integers(0, 500, n).astype(np.int32), clens, klens)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        cells = int((args[4][args[2].long()].long()
                     * args[5][args[3].long()].long()).sum())
        for algo, gaps in ALGO_GAPS:
            sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
            G = pair_lanes(n, args[1].shape[1], algo)
            lanes_seen.add(G)
            check_call("align_pairs", cuda_dp.align_pairs,
                       torch_dp.align_pairs_plain, args, sub, g, algo, label,
                       cells, err, times, G)
            log(f"(b) align_pairs {label:18s} {algo}: G={G}, == plain (exact)")
    want = {1 << k for k in range(6)}
    if lanes_seen != want:
        raise AssertionError(f"(b) lanes per pair launched {lanes_seen}, "
                             f"not {want}")
    log(f"(b) align_pairs launched every lanes per pair G in {sorted(want)}")
    return err, times


def check_call(name, kern, plain, args, sub, g, algo, label, cells, err,
               times, G=None):
    """One kernel call against its plain version, exact; for GA also the
    CUDA-event ms of both beside the call's bound."""
    from sequencealigner_tpu_torch.tools.profile_kernels import cuda_ms

    got = kern(*args, sub, g, algo=algo)
    torch.cuda.synchronize()
    want = plain(*args, sub, g, algo=algo)
    e = int((got.long() - want.long()).abs().max())
    err[name] = max(err[name], e)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {algo} {label}: max err {e}")
    if algo == "ga":
        t_k = cuda_ms(lambda: kern(*args, sub, g, algo=algo), 10)
        t_p = cuda_ms(lambda: plain(*args, sub, g, algo=algo), 2)
        b, by = bound(cells, [*args, sub, g, got])
        times[(name, label)] = (t_k, t_p, b, by)
        lanes = f"G={G} " if G else ""
        log(f"(b) {name:11s} {label:18s} GA  {lanes}kernel {t_k:.4f} ms"
            f"  plain {t_p:.4f} ms  bound {b:.4f} ms ({by}, {cells} cells)"
            f"  share {b / t_k:.3f}")


def cli(args, label, **kw):
    """seqalign-torch in a subprocess on the card: rc 0, and never the
    no-device warning (which would mean the CPU ran)."""
    r = subprocess.run(
        [sys.executable, "-m", "sequencealigner_tpu_torch.cli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300, **kw,
    )
    if r.returncode != 0 or NO_CUDA in r.stdout + r.stderr:
        raise AssertionError(f"{label} failed:\n{r.stdout}{r.stderr}")
    return r


#: The CLI's warning when it finds no CUDA device (it then asks for -C).
NO_CUDA = "No CUDA device found"


def phase_c(dev, M):
    from sequencealigner_tpu_torch import align
    from sequencealigner_tpu_torch.ops import oracle

    text = (ROOT / "examples" / "peptides.fasta").read_text().splitlines()
    seqs = [s.strip() for s in text if s.strip() and not s.startswith(">")]
    enc = [M.lut[np.frombuffer(s.encode(), np.uint8)] for s in seqs]
    for algo, (gap, opn, ext) in ALGO_GAPS:
        got = align(seqs, algo=algo, gap=-gap, open=-opn, extend=-ext,
                    device="cuda")
        for i in range(len(seqs)):
            for j in range(i + 1, len(seqs)):
                want = oracle.align_score(algo, enc[j], enc[i], M.matrix,
                                          gap=gap, opn=opn, ext=ext)
                if got[i, j] != want or got[j, i] != want:
                    raise AssertionError(f"align {algo} pair {i},{j}")
        log(f"(c) align() {algo} on peptides.fasta: {len(seqs)} sequences, "
            f"{len(seqs) * (len(seqs) - 1) // 2} pairs == oracle")
    cli(["-i", "examples/peptides.fasta", "-m", "blosum62", "-a", "ga", "-s",
         "10", "-e", "1", "-W", "-F", "-P"], "(c) seqalign-torch")
    log("(c) seqalign-torch -i examples/peptides.fasta -a ga -W -F: rc 0")


def zero_launches() -> None:
    from sequencealigner_tpu_torch.ops import cuda_dp

    for k in (cuda_dp.align_tiles, cuda_dp.align_pairs, cuda_dp.align_grid):
        k.launches = 0
        k.launches_by_device = {}


def launches_by_device() -> dict:
    """Per device, the launches of every kernel since zero_launches."""
    from sequencealigner_tpu_torch.ops import cuda_dp

    out: dict = {}
    for k in (cuda_dp.align_tiles, cuda_dp.align_pairs, cuda_dp.align_grid):
        for d, n in k.launches_by_device.items():
            out.setdefault(d, {})[k.__name__] = n
    return out


def read_launches() -> dict:
    from sequencealigner_tpu_torch.ops import cuda_dp

    return {k.__name__: k.launches for k in (
        cuda_dp.align_tiles, cuda_dp.align_pairs, cuda_dp.align_grid)}


def plain_sample(rng, dev, raw, lut, sub, gaps, algo, mat, k, label):
    """k sampled pairs of a finished matrix against the per-pair kernel's
    plain version on the card."""
    from sequencealigner_tpu_torch.ops import torch_dp

    n = len(raw)
    i = rng.integers(0, n, k)
    j = (i + rng.integers(1, n, k)) % n
    L = max(len(s) for s in raw)
    codes = np.full((n, L), 24, np.int8)
    for r, s in enumerate(raw):
        codes[r, : len(s)] = lut[s]
    lens = torch.tensor([len(s) for s in raw], dtype=torch.int32, device=dev)
    ct = torch.from_numpy(codes).to(dev)
    it = torch.from_numpy(i.astype(np.int32)).to(dev)
    jt = torch.from_numpy(j.astype(np.int32)).to(dev)
    plain = torch_dp.align_pairs_plain(ct, ct, it, jt, lens, lens, sub, gaps,
                                       algo=algo).cpu().numpy()
    if (plain != mat[i, j]).any():
        raise AssertionError(f"{label}: sampled pairs != plain version")
    return i, j


def phase_d(rng, dev, M, raw, card, label, oracle_pairs):
    """The main path once on ``raw``; returns (stats, launches, matrix)."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore
    from sequencealigner_tpu_torch.ops import oracle

    n = len(raw)
    lo, hi = min(map(len, raw)), max(map(len, raw))
    ss = SequenceSet.from_list(raw, M.lut)
    gaps = (0, -10, -1)
    eng = engine.Engine("ga", M.matrix, gaps, device=dev)
    store = OutputStore(n, triangular=False, spill=False)
    zero_launches()
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False)
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"(d) {label}: {n} seqs, lengths {lo}-{hi}, GA BLOSUM62 10/1 on "
        f"{card}: wall {wall:.3f} s, align {stats.seconds:.3f} s, "
        f"{stats.pairs} pairs, {stats.cells} cells, "
        f"{stats.gcups:.2f} GCUPS, launches {launches}")
    if (stats.pairs != n * (n - 1) // 2 or not launches["align_tiles"]
            or not launches["align_pairs"]):
        raise AssertionError(f"(d) {label}: pairs or launches wrong")
    mat = np.asarray(store.matrix).reshape(n, n)
    if (np.diag(mat) != 0).any() or not (mat == mat.T).all():
        raise AssertionError(f"(d) {label}: matrix not symmetric/zero diag")
    sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
    i, j = plain_sample(rng, dev, raw, M.lut, sub, g, "ga", mat, 4096,
                        f"(d) {label}")
    for p in range(oracle_pairs):
        want = oracle.ga_affine(M.lut[raw[i[p]]], M.lut[raw[j[p]]], M.matrix,
                                -10, -1)
        if mat[i[p], j[p]] != want:
            raise AssertionError(f"(d) {label}: pair {i[p]},{j[p]} != oracle")
    log(f"(d) {label}: {oracle_pairs} sampled pairs == oracle, 4096 sampled "
        "pairs == plain version on the card")
    return stats, launches, mat


def grid_block(rng, dev, n, Lc, Lk):
    """n random pairs (codes PAD beyond random lengths 1..L) on the card."""
    from sequencealigner_tpu_torch.ops.geometry import PAD

    out = []
    for L in (Lc, Lk):
        lens = rng.integers(1, L + 1, n).astype(np.int32)
        codes = rng.integers(0, 20, (n, L)).astype(np.int8)
        codes[np.arange(L)[None, :] >= lens[:, None]] = PAD
        out.append((torch.from_numpy(codes).to(dev),
                    torch.from_numpy(lens).to(dev)))
    (s1, l1), (s2, l2) = out
    return s1, s2, l1, l2


#: Lanes per superblock row that, with B = 128 (bulk copies a column),
#: launch every copy form and unit of the grid kernel (cuda_dp.grid_form):
#: 256 (two chunks) and 48 cp.async of 16 bytes, 100 and 200 of 4 and 8
#: bytes, 130 byte loads.
GRID_LANES = (256, 100, 48, 200, 130)


def grid_launch_line(sk) -> str:
    """The copy form, ring and grid of align_grid's GA launch on ``sk``,
    and the grid kernel's registers (nvcc's report) and resident blocks."""
    from sequencealigner_tpu_torch.ops import cuda_dp
    from sequencealigner_tpu_torch.tools.profile_main import registers

    lay = cuda_dp.grid_launch_layout(sk, "ga")
    regs = registers("grid_kernel")
    return (f"form {lay['form']} ({lay['unit']}-byte units), "
            f"{lay['stages']} stages, {lay['smem']} bytes of shared memory, "
            f"GA grid {lay['grid']}; grid_kernel registers "
            + ", ".join(f"{a} {regs.get(a)}" for a in ("nw", "ga", "sw"))
            + "; resident blocks per SM " + ", ".join(
                f"{a} {cuda_dp.grid_resident(a)}" for a in ("nw", "ga", "sw")))


def phase_e(rng, dev, M, card, seed):
    """The superblock entry points; returns (max error, (ms, plain ms) at
    GA 80 x 70, the full-size run's launches)."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.ops import cuda_dp, geometry, superblock
    from sequencealigner_tpu_torch.ops import torch_dp
    from sequencealigner_tpu_torch.tools import fuzz_hw
    from sequencealigner_tpu_torch.tools.profile_kernels import (
        cuda_ms, grid_bound)

    B = geometry.LANE
    err, times = 0, None
    for Lc, Lk, S in ((21, 13, 1), (80, 70, 1), (70, 40, 3)):
        s1, s2, l1, l2 = grid_block(rng, dev, S * B, Lc, Lk)
        nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
        for algo, gaps in ALGO_GAPS:
            sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
            sk = superblock.build_stream(s1, s2, sub, S=S, B=B, Lc=Lc, Lk=Lk,
                                         Kpad=Kpad, W=W)
            got = cuda_dp.align_grid(sk, l1, l2, g, algo=algo)
            torch.cuda.synchronize()
            want = torch_dp.align_grid_plain(sk, l1, l2, g, algo=algo)
            err = max(err, int((got.long() - want.long()).abs().max()))
            inline = superblock.align_superblock(
                s1, s2, l1, l2, sub, g, algo=algo, Lc=Lc, Lk=Lk, B=B,
                inline=True)
            if not torch.equal(got, want) or not torch.equal(inline, want):
                raise AssertionError(f"(e) align_grid {algo} {Lc}x{Lk}")
            if algo == "ga" and (Lc, Lk) == (80, 70):
                cells = int((l1.long() * l2.long()).sum())
                b, by, traffic = grid_bound(
                    l1.cpu().numpy(), l2.cpu().numpy(), S, W, Kpad, B, "ga")
                times = (
                    cuda_ms(lambda: cuda_dp.align_grid(sk, l1, l2, g,
                                                       algo="ga"), 10),
                    cuda_ms(lambda: torch_dp.align_grid_plain(
                        sk, l1, l2, g, algo="ga"), 2),
                    b, by,
                )
                log(f"(e) align_grid 80x70 GA kernel {times[0]:.4f} ms  "
                    f"plain {times[1]:.4f} ms  bound {b:.4f} ms ({by}, "
                    f"{traffic['needed']} of the grid's {traffic['grid']} "
                    f"bytes needed, {cells} cells)  share "
                    f"{b / times[0]:.3f}")
        log(f"(e) align_grid and inline align_superblock {Lc}x{Lk} S={S}: "
            "NW/GA/SW == plain (exact); " + grid_launch_line(sk))
    forms = {cuda_dp.grid_launch_layout(sk, "ga")["form"]}
    for lanes in GRID_LANES:
        Lc, Lk, S = 70, 40, 2
        s1, s2, l1, l2 = grid_block(rng, dev, S * lanes, Lc, Lk)
        nb, Kpad, CD, W = geometry.geometry(Lc, Lk, lanes)
        for algo, gaps in ALGO_GAPS:
            sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
            sk = superblock.build_stream(s1, s2, sub, S=S, B=lanes, Lc=Lc,
                                         Lk=Lk, Kpad=Kpad, W=W)
            got = cuda_dp.align_grid(sk, l1, l2, g, algo=algo)
            torch.cuda.synchronize()
            want = torch_dp.align_grid_plain(sk, l1, l2, g, algo=algo)
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"(e) align_grid {algo} B={lanes}")
        forms.add(cuda_dp.grid_launch_layout(sk, "ga")["form"])
        log(f"(e) align_grid {Lc}x{Lk} S={S} B={lanes}: NW/GA/SW == plain "
            f"(exact); " + grid_launch_line(sk))
    if forms != set(cuda_dp.GRID_FORMS):
        raise AssertionError(f"(e) align_grid launched forms {forms}")
    Lc = Lk = 256
    nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
    S = geometry.pick_S(B, Kpad, W)
    s1, s2, l1, l2 = grid_block(rng, dev, S * B, Lc, Lk)
    sub, g = engine.from_reference_inputs(M.matrix, (0, -10, -1), dev)
    kw = dict(algo="ga", Lc=Lc, Lk=Lk, B=B)
    zero_launches()
    grid = superblock.align_superblock(s1, s2, l1, l2, sub, g, **kw)
    inline = superblock.align_superblock(s1, s2, l1, l2, sub, g, inline=True,
                                         **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"align_tiles": 0, "align_pairs": 1, "align_grid": 1}:
        raise AssertionError(f"(e) full size launches {launches}")
    sk = superblock.build_stream(s1, s2, sub, S=S, B=B, Lc=Lc, Lk=Lk,
                                 Kpad=Kpad, W=W)
    want = torch_dp.align_grid_plain(sk, l1, l2, g, algo="ga")
    err = max(err, int((grid.long() - want.long()).abs().max()))
    for name, got in (("grid", grid), ("inline", inline)):
        if not torch.equal(got, want):
            raise AssertionError(f"(e) full size {name} != plain")
    t_build = cuda_ms(lambda: superblock.build_stream(
        s1, s2, sub, S=S, B=B, Lc=Lc, Lk=Lk, Kpad=Kpad, W=W), 3)
    t_grid = cuda_ms(lambda: cuda_dp.align_grid(sk, l1, l2, g, algo="ga"), 5)
    t_inline = cuda_ms(lambda: superblock.align_superblock(
        s1, s2, l1, l2, sub, g, inline=True, **kw), 5)
    t_plain = cuda_ms(lambda: torch_dp.align_grid_plain(sk, l1, l2, g,
                                                        algo="ga"), 1)
    cells = int((l1.long() * l2.long()).sum())
    b, by, traffic = grid_bound(l1.cpu().numpy(), l2.cpu().numpy(), S, W,
                                Kpad, B, "ga")
    wb, wby = bound(cells, [sk, l1, l2, g, grid])
    log(f"(e) align_superblock GA 256x256 S={S} ({S * B} pairs, "
        f"{sk.numel() / 2**30:.2f} GiB grid) on {card}: grid and inline == "
        f"plain (exact); build_stream {t_build:.4f} ms, align_grid "
        f"{t_grid:.4f} ms ({cells / t_grid / 1e6:.1f} GCUPS true, "
        f"{sk.numel() / t_grid / 1e6:.1f} Gcell/s padded, "
        f"{traffic['copied'] / t_grid / 1e9:.3f} TB/s copied; bound "
        f"{b:.4f} ms of the {traffic['needed']} bytes the lengths need in "
        f"32-byte sectors, {by}, share {b / t_grid:.3f}; whole grid "
        f"{wb:.4f} ms, {wby}, share {wb / t_grid:.3f}; copied "
        f"{traffic['copied']} bytes), inline {t_inline:.4f} ms, plain "
        f"{t_plain:.4f} ms; launches {launches}; {grid_launch_line(sk)}")
    del sk, grid, inline, want
    fuzz_hw.run(seed, 8, log=lambda m: log(f"(e) fuzz_hw {m}"))
    return err, times, launches


def run_set(eng, raw, lut, label, card):
    """One full run into a square store; returns (stats, launches, matrix)."""
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore

    n = len(raw)
    ss = SequenceSet.from_list(raw, lut)
    token = eng.schedule_token(ss.lengths)
    store = OutputStore(n, triangular=False, spill=False)
    zero_launches()
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False)
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"{label} on {card}: {n} seqs, token {token}, wall {wall:.3f} s, "
        f"align {stats.seconds:.3f} s, {stats.pairs} pairs, {stats.cells} "
        f"cells, {stats.gcups:.2f} GCUPS, launches {launches}")
    if (not token.startswith("linear-v1") or stats.pairs != n * (n - 1) // 2
            or launches["align_tiles"] or not launches["align_pairs"]):
        raise AssertionError(f"{label}: token, pairs or launches wrong")
    return stats, launches, np.asarray(store.matrix).reshape(n, n)


def phase_f(dev, M, raw, tiles_mat, card):
    """linear-v1 on the main set; then both schedules in turns, twice, each
    once under the profiler (per kernel device ms, launches, bound and
    share) and once not (wall time); and the registers and resident blocks
    per SM of the tile kernel and of both forms of the per-pair kernel."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.tools import profile_main

    eng = profile_main.linear_engine("ga", M.matrix, (0, -10, -1), dev)
    _, _, mat = run_set(eng, raw, M.lut, "(f) linear-v1 main", card)
    if not np.array_equal(mat, tiles_mat):
        raise AssertionError("(f) linear-v1 matrix != tiles-v2 matrix")
    log("(f) linear-v1 matrix == tiles-v2 matrix, element for element")
    for line in profile_main.occupancy_lines():
        log(f"(f) {line}")
    ss = SequenceSet.from_list(raw, M.lut)
    bounds = profile_main.schedule_bounds(ss.lengths, "ga")
    engines = {"tiles-v2": engine.Engine("ga", M.matrix, (0, -10, -1),
                                         device=dev), "linear-v1": eng}
    prof = profile_main.turns(
        engines, ss, bounds, 2, log=log,
        tag=lambda label: "(d) " if label == "tiles-v2" else "(f) ")
    for r in prof["tiles-v2"]:
        if not np.array_equal(r["matrix"], tiles_mat):
            raise AssertionError("(d) profiled tiles-v2: matrix differs")


def phase_g(rng, dev, card):
    from sequencealigner_tpu_torch import align, engine, matrices
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.ops import geometry
    from sequencealigner_tpu_torch.scheduler import Schedule
    from sequencealigner_tpu_torch.tools import profile_main
    from sequencealigner_tpu_torch.tools.profile_main import proteins

    nuc = matrices.get("nuc44")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    dna = [rng.choice(acgt, int(rng.integers(3000, 9001))) for _ in range(128)]
    gaps = (0, -10, -1)
    eng = engine.Engine("sw", nuc.matrix, gaps, device=dev)
    stats, _, mat = run_set(eng, dna, nuc.lut, "(g) long DNA SW NUC44", card)
    if max(map(len, dna)) <= geometry.W_MAX:
        raise AssertionError("(g) no sequence beyond W_MAX")
    sub, g = engine.from_reference_inputs(nuc.matrix, gaps, dev)
    plain_sample(rng, dev, dna, nuc.lut, sub, g, "sw", mat, 64, "(g) long")
    log(f"(g) long: 64 sampled pairs == plain version on the card; "
        f"{stats.gcups:.2f} GCUPS")
    ss = SequenceSet.from_list(dna, nuc.lut)
    r = profile_main.profiled_run(eng, ss)
    if not np.array_equal(r["matrix"], mat):
        raise AssertionError("(g) profiled long run: matrix differs")
    b = profile_main.schedule_bounds(ss.lengths, "sw")["linear-v1"]
    ms, n = r["ms"]["align_pairs"], r["launches"]["align_pairs"]
    # One bucket, so one launch of all the pairs (its G as the wrapper
    # picks it).
    edge = Schedule.build(ss.lengths).buckets[-1].edge
    if n != 1:
        raise AssertionError(f"(g) long: {n} per-pair launches, not one")
    log(f"(g) long profiled: pairs_kernel device {ms:.3f} ms in one launch "
        f"of {stats.pairs} pairs, G={pair_lanes(stats.pairs, edge, 'sw')}, "
        f"bound {b['align_pairs']:.3f} ms, share of bound "
        f"{b['align_pairs'] / ms:.3f}; wall {r['wall']:.3f} s")
    few = [s.tobytes().decode() for s in dna if len(s) > geometry.W_MAX][:3]
    got = align(few, algo="sw", matrix="nuc44", open=10, extend=1,
                device=dev.type)
    plain_sample(rng, dev, [np.frombuffer(s.encode(), np.uint8) for s in few],
                 nuc.lut, sub, g, "sw", got, 16, "(g) align() long")
    with tempfile.TemporaryDirectory() as td:
        fa = Path(td) / "long.fasta"
        fa.write_text("".join(f">s{k}\n{s}\n" for k, s in enumerate(few)))
        cli(["-i", str(fa), "-m", "nuc44", "-a", "sw", "-s", "10", "-e", "1",
             "-W", "-F", "-P"], "(g) seqalign-torch long")
    log(f"(g) align() on {len(few)} sequences over {geometry.W_MAX} nt == "
        "plain; seqalign-torch -m nuc44 -a sw -W on them: rc 0")
    blosum = matrices.get("blosum62")
    wide = blosum.matrix.astype(np.int64) * 20
    raw = proteins(rng, 512, 50, 500)
    eng = engine.Engine("ga", wide, gaps, device=dev)
    stats, _, mat = run_set(eng, raw, blosum.lut,
                            "(g) wide BLOSUM62x20 GA 10/1", card)
    sub, g = engine.from_reference_inputs(wide, gaps, dev)
    plain_sample(rng, dev, raw, blosum.lut, sub, g, "ga", mat, 256,
                 "(g) wide")
    log(f"(g) wide: max |score| {int(np.abs(wide).max())}, 256 sampled pairs"
        f" == plain version on the card; {stats.gcups:.2f} GCUPS")


def filter_set(rng, n=16384, copies=2048, prefixes=256):
    """n proteins of 50-500: ``copies`` near-copies (at most 5% of
    positions substituted) and ``prefixes`` prefix truncations (50 or
    more residues) of an earlier original, the rest originals.  Returns
    (sequences, original indices in order)."""
    from sequencealigner_tpu_torch.tools.profile_main import RESIDUES

    derived = np.sort(rng.choice(np.arange(n // 16, n), copies + prefixes,
                                 replace=False))
    kind = np.zeros(n, np.int8)
    kind[derived] = 1
    kind[rng.choice(derived, prefixes, replace=False)] = 2
    seqs, originals = [], []
    for i in range(n):
        if kind[i] == 0:
            originals.append(i)
            seqs.append(rng.choice(RESIDUES, int(rng.integers(50, 501))))
            continue
        src = seqs[originals[int(rng.integers(0, len(originals)))]]
        if kind[i] == 2:
            seqs.append(src[: int(rng.integers(50, len(src) + 1))].copy())
            continue
        s = src.copy()
        for q in rng.choice(len(s), int(rng.integers(0, len(s) // 20 + 1)),
                            replace=False):
            s[q] = rng.choice(RESIDUES[RESIDUES != s[q]])
        seqs.append(s)
    return seqs, np.asarray(originals, np.int64)


def write_fasta(path: Path, seqs) -> None:
    path.write_text("".join(f">s{k}\n{s.tobytes().decode()}\n"
                            for k, s in enumerate(seqs)))


def phase_h(rng, dev, M, card):
    """The similarity filter on the card; returns its seconds."""
    from sequencealigner_tpu_torch.filter import filter_sequences
    from sequencealigner_tpu_torch.io.input import SequenceSet

    seqs, originals = filter_set(rng)
    ss = SequenceSet.from_list(seqs, M.lut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, dropped = filter_sequences(ss, 0.9, progress=False, device=dev)
    secs = time.perf_counter() - t0
    if not np.array_equal(out.kept, originals) or dropped != len(seqs) - len(
            originals):
        raise AssertionError(f"(h) filter kept {out.num}, dropped {dropped}; "
                             f"constructed originals {len(originals)}")
    log(f"(h) filter 0.9 on {card}: {len(seqs)} proteins of 50-500, "
        f"{dropped} dropped (2048 near-copies, 256 prefixes), kept == the "
        f"constructed originals exactly; {secs:.3f} s")
    sub = SequenceSet.from_list(seqs[:2048], M.lut)
    t0 = time.perf_counter()
    got, d_card = filter_sequences(sub, 0.9, progress=False, device=dev)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, d_cpu = filter_sequences(sub, 0.9, progress=False, device="cpu")
    t_cpu = time.perf_counter() - t0
    if d_card != d_cpu or not np.array_equal(got.kept, want.kept):
        raise AssertionError("(h) card != CPU on the 2,048 subset")
    expect = int((originals < 2048).sum())
    if len(got.kept) != expect:
        raise AssertionError(f"(h) subset kept {len(got.kept)} != {expect}")
    with tempfile.TemporaryDirectory() as td:
        fa = Path(td) / "subset.fasta"
        write_fasta(fa, seqs[:2048])
        r = cli(["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10",
                 "-e", "1", "-f", "0.9", "-W", "-F", "-P"], "(h) -f 0.9")
    if f"Filtered out {d_card} sequences" not in r.stdout:
        raise AssertionError(f"(h) CLI -f 0.9:\n{r.stdout}")
    log(f"(h) 2,048-sequence subset: card == CPU ({d_card} dropped), card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s; seqalign-torch -f 0.9 on it: "
        f"rc 0, \"Filtered out {d_card} sequences\"")
    return secs


def resume_run(eng, ss, td, tag, resumer=None):
    """One run cut by limit_pairs at half the pairs into a sentinel-filled
    persistent store (commits at every flush), then resumed by ``resumer``
    (default ``eng``); returns (matrix, interrupted stats, resumed stats,
    resumed launches, sentinels the cut left)."""
    from sequencealigner_tpu_torch import checkpoint, engine
    from sequencealigner_tpu_torch.io.output import OutputStore

    n = ss.num
    total = n * (n - 1) // 2
    jpath, spath = Path(td) / f"{tag}.ckpt", Path(td) / f"{tag}.scores"
    pre = checkpoint.persistent_array(spath, total)
    pre[:] = -777
    pre.flush()
    del pre
    header = checkpoint.config_fingerprint(
        algo="ga", gaps=(0, -10, -1), matrix="blosum62", num_seqs=n,
        lengths=ss.lengths, triangular=True, data=ss.data,
        schedule=eng.schedule_token(ss.lengths))
    engine.SYNC_INTERVAL = 0.0
    runs = []
    for run, limit in ((eng, total // 2), (resumer or eng, None)):
        store = OutputStore(n, triangular=True, spill=False,
                            persist_path=spath)
        journal = checkpoint.Journal(jpath, header)
        zero_launches()
        stats = run.align_all(ss, store, progress=False, journal=journal,
                              limit_pairs=limit)
        journal.close()
        # Pairs the run left unwritten (none after the resumed run).
        left = int((np.asarray(store.matrix) == -777).sum())
        runs.append((stats, read_launches(), left))
    (cut, _, left), (res, launches, rest) = runs
    if rest or not left or res.pairs_resumed <= 0 or res.pairs + res.pairs_resumed != \
            total or cut.pairs + res.pairs != total:
        raise AssertionError(f"(i) {tag}: pairs {cut.pairs}/{res.pairs}/"
                             f"{res.pairs_resumed}, {left} sentinels")
    return store.rows(0, n), cut, res, launches, left


class StandInWriter:
    """Where h5py is not installed, the CLI's HDF5 writer is replaced by
    a NumPy file of the same two datasets (``/sequences`` and
    ``/similarity_matrix`` as hdf5_io.write fills them)."""

    def __init__(self):
        from sequencealigner_tpu_torch.io import hdf5_io

        self.mod, self.real = hdf5_io, hdf5_io.write

    def __enter__(self):
        def write(path, store, seqs, **kw):
            with open(path, "wb") as f:
                np.savez(f, sequences=np.array(
                    [seqs.get_str(i) for i in range(seqs.num)]),
                    similarity_matrix=store.rows(0, store.dim))
        self.mod.write = write
        return self

    def __exit__(self, *exc):
        self.mod.write = self.real


def read_output(path: Path):
    try:
        import h5py
    except ImportError:
        with np.load(path) as z:
            return list(z["sequences"]), z["similarity_matrix"]
    with h5py.File(path) as f:
        return (list(f["/sequences"].asstr()),
                f["/similarity_matrix"][...])


def cli_in_process(argv, label):
    """seqalign-torch in this process (so a missing h5py can be stood in
    for); returns its standard output."""
    from sequencealigner_tpu_torch import cli as port_cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_cli.run(argv)
    text = out.getvalue() + err.getvalue()
    if rc != 0 or NO_CUDA in text:
        raise AssertionError(f"{label}: rc {rc}\n{text}")
    return out.getvalue()


def phase_i(rng, dev, M, raw, tiles_mat, card):
    """Checkpoint/resume on the card; returns the seconds of each run."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.tools import profile_main
    from sequencealigner_tpu_torch.tools.profile_main import proteins

    ss = SequenceSet.from_list(raw, M.lut)
    secs = {}
    sync = engine.SYNC_INTERVAL
    try:
        with tempfile.TemporaryDirectory() as td:
            for tag, eng in (
                ("tiles-v2", engine.Engine("ga", M.matrix, (0, -10, -1),
                                           device=dev)),
                ("linear-v1", profile_main.linear_engine(
                    "ga", M.matrix, (0, -10, -1), dev)),
            ):
                mat, cut, res, launches, left = resume_run(eng, ss, td, tag)
                if not np.array_equal(mat, tiles_mat):
                    raise AssertionError(f"(i) {tag}: resumed != (d)")
                used = "align_tiles" if tag == "tiles-v2" else "align_pairs"
                if not launches[used] or not launches["align_pairs"]:
                    raise AssertionError(f"(i) {tag}: launches {launches}")
                secs[tag] = (cut.seconds, res.seconds)
                log(f"(i) {tag} on {card}: cut at half: {cut.pairs} pairs "
                    f"in {cut.seconds:.3f} s ({left} sentinel entries left); "
                    f"resumed: {res.pairs_resumed} pairs from the journal, "
                    f"{res.pairs} computed in {res.seconds:.3f} s, launches "
                    f"{launches}; matrix == (d)'s uninterrupted run")
    finally:
        engine.SYNC_INTERVAL = sync
    few = proteins(rng, 300, 50, 500)
    h5py = importlib.util.find_spec("h5py") is not None
    with tempfile.TemporaryDirectory() as td, (
            contextlib.nullcontext() if h5py else StandInWriter()):
        fa = Path(td) / "few.fasta"
        write_fasta(fa, few)
        base = ["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10",
                "-e", "1", "-F", "-P", "-k", str(Path(td) / "run.ckpt")]
        first = cli_in_process(base + ["-o", str(Path(td) / "a.h5")],
                               "(i) -k first")
        second = cli_in_process(base + ["-o", str(Path(td) / "b.h5")],
                                "(i) -k second")
        a, b = (read_output(Path(td) / x) for x in ("a.h5", "b.h5"))
        if "Resuming" in first or "Resuming:" not in second or a[0] != b[0] \
                or not np.array_equal(a[1], b[1]):
            raise AssertionError("(i) -k twice: no resume or outputs differ")
        resumed = next(ln for ln in second.splitlines() if "Resuming" in ln)
        trace = Path(td) / "trace"
        cli(["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10", "-e",
             "1", "-W", "-F", "-P", "-t", str(trace)], "(i) -t")
        files = sorted(trace.glob("*.json"))
        if not files or "tiles_kernel" not in files[0].read_text():
            raise AssertionError(f"(i) -t: no tiles_kernel in {files}")
        traced = f"{files[0].name} ({files[0].stat().st_size} bytes)"
    writer = "HDF5" if h5py else (
        "output (h5py is not installed here: a NumPy file of the same two "
        "datasets)")
    log(f"(i) seqalign-torch -k twice on 300 proteins: the second run "
        f"printed \"{resumed.strip('• ')}\" and wrote the same {writer}; "
        f"-t: {traced} names tiles_kernel")
    return secs


def multi_run(eng, ss, label, want):
    """One timed run of ``eng`` on ``ss`` into a square store, its launch
    counts zeroed just before; the matrix must equal ``want``.  Returns
    (wall seconds, stats, launches, launches by device)."""
    from sequencealigner_tpu_torch.io.output import OutputStore

    store = OutputStore(ss.num, triangular=False, spill=False)
    zero_launches()
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False)
    wall = time.perf_counter() - t0
    launches, by_dev = read_launches(), launches_by_device()
    if not np.array_equal(np.asarray(store.matrix).reshape(ss.num, ss.num),
                          want):
        raise AssertionError(f"{label}: matrix != (d)'s")
    return wall, stats, launches, by_dev


def phase_j(dev, M, raw, tiles_mat, card):
    """Several devices on one host (see the head comment)."""
    from sequencealigner_tpu_torch import engine, entry
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.tools import profile_main

    ss = SequenceSet.from_list(raw, M.lut)
    gaps = (0, -10, -1)
    lists = [["cuda:0", "cuda:0"]]
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        lists.append([f"cuda:{k}" for k in range(ncards)])
    else:
        log("(j) this machine has one card: the run on distinct cards was "
            "not possible")
    for tag, build in (
        ("tiles-v2", lambda d: engine.Engine("ga", M.matrix, gaps, device=d)),
        ("linear-v1", lambda d: profile_main.linear_engine("ga", M.matrix,
                                                           gaps, d)),
    ):
        kernels = (("align_tiles", "align_pairs") if tag == "tiles-v2"
                   else ("align_pairs",))
        one, _, _, _ = multi_run(build(dev), ss, f"(j) {tag} one device",
                                 tiles_mat)
        for devs in lists:
            label = f"(j) {tag} on {devs}"
            wall, stats, launches, by_dev = multi_run(build(devs), ss, label,
                                                      tiles_mat)
            if (min(stats.lane_launches) == 0
                    or set(by_dev) != set(map(str, engine.resolve_devices(devs)))
                    or not all(launches[k] for k in kernels)):
                raise AssertionError(f"{label}: entries {stats.lane_launches}"
                                     f", launches {by_dev}")
            log(f"{label} on {card}: matrix == (d)'s; wall {wall:.3f} s "
                f"(one device in this phase {one:.3f} s), align "
                f"{stats.seconds:.3f} s, {stats.gcups:.2f} GCUPS; launch "
                f"groups per entry {stats.lane_launches}, cells per entry "
                f"{stats.lane_cells}; launches {launches}, by device {by_dev}")
    with tempfile.TemporaryDirectory() as td:
        sync = engine.SYNC_INTERVAL
        try:
            mat, cut, res, launches, left = resume_run(
                engine.Engine("ga", M.matrix, gaps, device=dev), ss, td,
                "multi", resumer=engine.Engine("ga", M.matrix, gaps,
                                               device=lists[0]))
        finally:
            engine.SYNC_INTERVAL = sync
    if not np.array_equal(mat, tiles_mat) or not launches["align_tiles"]:
        raise AssertionError("(j) resume on two entries != (d)")
    log(f"(j) cut on one device at {cut.pairs} pairs, resumed on "
        f"{lists[0]}: {res.pairs_resumed} pairs from the journal, "
        f"{res.pairs} computed, launch groups per entry "
        f"{res.lane_launches}; matrix == (d)'s")
    out = entry.dryrun_multidevice(lists[0])
    log(f"(j) entry.dryrun_multidevice({lists[0]}): {out['pairs']} pairs, "
        f"matrix == one device's and symmetric; launch groups per entry "
        f"{out['launches']}, cells {out['cells']}")


#: Keys of the [phases] line with a store (the reference's, engine.py).
PHASE_KEYS = {"schedule+dispatch", "flush.materialize", "flush.fetch_wait",
              "final_flush"}

#: A fresh process of (l): load the kernel library, say from where.
LOAD_LIBRARY = (
    "from sequencealigner_tpu_torch.ops import cuda_dp\n"
    "lib = cuda_dp.load_library()\n"
    "print(lib._name)\n"
    "print(cuda_dp.build_seconds)\n"
)


def phases_run(eng, raw, lut, label, tiles_mat, phases: bool):
    """One align_all of ``raw`` into a square store, with
    SEQALIGN_TPU_DEBUG_PHASES set or unset; returns (wall, launches, the
    [phases] line or None)."""
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore

    n = len(raw)
    ss = SequenceSet.from_list(raw, lut)
    store = OutputStore(n, triangular=False, spill=False)
    out = io.StringIO()
    with mock.patch.dict(os.environ), contextlib.redirect_stdout(out):
        os.environ.pop("SEQALIGN_TPU_DEBUG_PHASES", None)
        if phases:
            os.environ["SEQALIGN_TPU_DEBUG_PHASES"] = "1"
        zero_launches()
        t0 = time.perf_counter()
        eng.align_all(ss, store, progress=False)
        wall = time.perf_counter() - t0
    launches = read_launches()
    if not np.array_equal(np.asarray(store.matrix).reshape(n, n), tiles_mat):
        raise AssertionError(f"{label}: matrix != (d)'s")
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("[phases]")]
    if len(lines) != (1 if phases else 0):
        raise AssertionError(f"{label}: [phases] lines {lines}")
    return wall, launches, lines[0] if lines else None


def load_in_process(env: dict):
    """Start a fresh process that loads the kernel library under ``env``."""
    return subprocess.Popen(
        [sys.executable, "-c", LOAD_LIBRARY], cwd=ROOT,
        env={**os.environ, **env, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def loaded(proc, label):
    """(library path, nvcc seconds) of a process of ``load_in_process``."""
    out, err = proc.communicate(timeout=HOST_DEADLINE)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exited {proc.returncode}:\n{err}")
    so, secs = out.splitlines()[-2:]
    return Path(so), float(secs)


def package_files() -> set:
    pkg = ROOT / "sequencealigner_tpu_torch"
    return {p for p in pkg.rglob("*") if "__pycache__" not in p.parts}


def phase_l(dev, M, raw, tiles_mat, card):
    """The phase breakdown and the build cache (see the head comment)."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.tools import profile_main

    gaps = (0, -10, -1)
    for tag, build in (
        ("tiles-v2", lambda: engine.Engine("ga", M.matrix, gaps, device=dev)),
        ("linear-v1", lambda: profile_main.linear_engine("ga", M.matrix, gaps,
                                                         dev)),
    ):
        label = f"(l) {tag}"
        eng = build()
        unset, _, _ = phases_run(eng, raw, M.lut, label, tiles_mat, False)
        wall, launches, line = phases_run(eng, raw, M.lut, label, tiles_mat,
                                          True)
        parts = dict(p.split("=") for p in line.split()[1:])
        ms = {k: float(v.removesuffix("ms")) for k, v in parts.items()}
        if set(ms) != PHASE_KEYS | {"wall"} or min(ms.values()) < 0:
            raise AssertionError(f"{label}: {line}")
        if not launches["align_pairs"] or (
                bool(launches["align_tiles"]) != (tag == "tiles-v2")):
            raise AssertionError(f"{label}: launches {launches}")
        log(f"{label} on {card}: matrix == (d)'s; wall {wall:.3f} s with "
            f"SEQALIGN_TPU_DEBUG_PHASES, {unset:.3f} s without (no line); "
            f"launches {launches}")
        log(f"{label} {line}")
    before = package_files()
    with tempfile.TemporaryDirectory() as cache, \
            tempfile.TemporaryDirectory() as tmp:
        first = load_in_process({"SEQALIGN_TPU_CACHE": cache})
        off = load_in_process({"SEQALIGN_TPU_CACHE": "0", "TMPDIR": tmp})
        so, secs = loaded(first, "(l) first load")
        so_off, secs_off = loaded(off, '(l) load under "0"')
        so2, secs2 = loaded(load_in_process({"SEQALIGN_TPU_CACHE": cache}),
                            "(l) second load")
        if (secs <= 0 or so.parent != Path(cache) or not so.exists()
                or package_files() != before):
            raise AssertionError(f"(l) first load: {so}, {secs} s")
        if so2 != so or secs2 != 0.0:
            raise AssertionError(f"(l) second load: {so2}, {secs2} s")
        if secs_off <= 0 or so_off.parent.parent != Path(tmp) \
                or so_off.parent.exists():
            raise AssertionError(f'(l) load under "0": {so_off}, {secs_off} s')
    log(f"(l) kernel cache: first process built into a new SEQALIGN_TPU_CACHE "
        f"(nvcc {secs:.2f} s), nothing new under the package; a second "
        f"loaded it (nvcc {secs2:.2f} s); under \"0\" a private build (nvcc "
        f"{secs_off:.2f} s) left no directory")


#: Seconds a host process of (k) may take, start-up included.
HOST_DEADLINE = 300


def run_hosts(argv, label):
    """``argv`` (arguments of this script) as two host processes under the
    multi-host environment, both on cuda:0; each must exit 0 within
    HOST_DEADLINE seconds.  Returns their outputs."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for h in range(2):
        env = dict(os.environ, SEQALIGN_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SEQALIGN_TPU_NUM_PROCESSES="2",
                   SEQALIGN_TPU_PROCESS_ID=str(h))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), *argv], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=HOST_DEADLINE)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for h, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: host {h} exited {p.returncode}:"
                                 f"\n{out[-4000:]}")
    return outs


def host_child(mode: str, workdir: Path) -> int:
    """One host of (k), in its own process: ``lib`` scores its stripe of
    the main set (saved by the parent in ``workdir``) and merges; ``cli``
    runs seqalign-torch with the arguments in ``workdir``/argv.json."""
    from sequencealigner_tpu_torch import cli, matrices
    from sequencealigner_tpu_torch.engine import Engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore
    from sequencealigner_tpu_torch.parallel import multihost

    if mode == "cli":
        h5py = importlib.util.find_spec("h5py") is not None
        with contextlib.nullcontext() if h5py else StandInWriter():
            return cli.run(json.loads((workdir / "argv.json").read_text()))
    host, nhosts = multihost.init_from_env(timeout=HOST_DEADLINE)
    M = matrices.get("blosum62")
    with np.load(workdir / "main.npz") as z:
        raw = np.split(z["data"], np.cumsum(z["lengths"])[:-1])
    ss = SequenceSet.from_list(raw, M.lut)
    eng = Engine("ga", M.matrix, (0, -10, -1), device="cuda:0")
    merger = multihost.TripletMerger(nhosts)
    store = OutputStore(ss.num, triangular=False, spill=False)
    zero_launches()
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False, partition=(host, nhosts),
                          merger=merger)
    wall = time.perf_counter() - t0
    np.save(workdir / f"host{host}.npy",
            np.asarray(store.matrix).reshape(ss.num, ss.num))
    print(json.dumps({
        "host": host, "pairs": stats.pairs, "cells": stats.cells,
        "wall": wall, "merges": merger.calls, "merge_s": merger.seconds,
        "merge_bytes": merger.bytes, "launches": read_launches(),
    }), flush=True)
    return 0


def phase_k(rng, M, raw, tiles_mat, card):
    """Two hosts on one machine (see the head comment)."""
    from sequencealigner_tpu_torch.tools.profile_main import proteins

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        np.savez(td / "main.npz", data=np.concatenate(raw),
                 lengths=np.asarray([len(s) for s in raw]))
        t0 = time.perf_counter()
        outs = run_hosts(["--host-child", "lib", "--workdir", str(td)],
                         "(k) library run")
        secs = time.perf_counter() - t0
        res = [json.loads(next(ln for ln in reversed(o.splitlines())
                               if ln.startswith("{"))) for o in outs]
        for r in sorted(res, key=lambda r: r["host"]):
            if not np.array_equal(np.load(td / f"host{r['host']}.npy"),
                                  tiles_mat):
                raise AssertionError(f"(k) host {r['host']}: store != (d)")
            log(f"(k) library host {r['host']} of 2 on {card}: store == "
                f"(d)'s matrix; {r['pairs']} pairs, {r['cells']} cells, "
                f"align wall {r['wall']:.3f} s, {r['merges']} merges in "
                f"{r['merge_s']:.3f} s, {r['merge_bytes']} bytes sent, "
                f"launches {r['launches']}")
        cells = [r["cells"] for r in res]
        n = len(raw)
        if (sum(r["pairs"] for r in res) != n * (n - 1) // 2
                or len({r["merges"] for r in res}) != 1
                or not all(sum(r["launches"][k] for r in res)
                           for k in ("align_tiles", "align_pairs"))):
            raise AssertionError(f"(k) library run: {res}")
        log(f"(k) library run: larger share of cells over the mean "
            f"{max(cells) / (sum(cells) / 2):.4f}; both processes "
            f"{secs:.1f} s from start to exit")
        few = proteins(rng, 300, 50, 500)
        fa = td / "few.fasta"
        write_fasta(fa, few)
        base = ["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10",
                "-e", "1", "-F", "-P"]
        (td / "argv.json").write_text(json.dumps(
            base + ["-o", str(td / "two.h5"), "-k", str(td / "run.ckpt")]))
        outs = run_hosts(["--host-child", "cli", "--workdir", str(td)],
                         "(k) CLI run")
        for h, o in enumerate(outs):
            if f"Distributed: host {h} of 2" not in o or NO_CUDA in o:
                raise AssertionError(f"(k) CLI host {h}:\n{o[-4000:]}")
        h5py = importlib.util.find_spec("h5py") is not None
        with contextlib.nullcontext() if h5py else StandInWriter():
            cli_in_process(base + ["-o", str(td / "one.h5")],
                           "(k) one-process CLI")
        two, one = read_output(td / "two.h5"), read_output(td / "one.h5")
        journals = sorted(p.name for p in td.glob("run.ckpt*"))
        if two[0] != one[0] or not np.array_equal(two[1], one[1]) or \
                journals != ["run.ckpt.h0", "run.ckpt.h0.scores",
                             "run.ckpt.h1", "run.ckpt.h1.scores"]:
            raise AssertionError(f"(k) CLI: output differs or journals "
                                 f"{journals}")
    log(f"(k) seqalign-torch -k as two hosts on 300 proteins: host 0's "
        f"output == a one-process run's; journals {journals}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-child", choices=("lib", "cli"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Build into the checkout's git-ignored _build/, as before the cache.
    os.environ.setdefault("SEQALIGN_TPU_CACHE",
                          str(ROOT / "sequencealigner_tpu_torch" / "_build"))
    sys.path.insert(0, str(ROOT))
    if args.host_child:
        return host_child(args.host_child, args.workdir)
    from sequencealigner_tpu_torch import matrices
    from sequencealigner_tpu_torch.ops import cuda_dp
    from sequencealigner_tpu_torch.tools.profile_main import proteins

    dev = torch.device("cuda", 0)
    card = smi()
    log(f"(a) card: {card}")
    log(f"(a) torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_dp.load_library()
    log(f"(a) kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_dp.build_seconds:.2f} s)")
    for line in cuda_dp.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"(a) {line.strip()}")
    M = matrices.get("blosum62")
    rng = np.random.default_rng(args.seed)
    err, times = phase_b(rng, dev, M)
    phase_c(dev, M)
    main_set = proteins(rng, 4096, 50, 500)
    _, launches, tiles_mat = phase_d(rng, dev, M, main_set, card, "main", 32)
    phase_d(rng, dev, M, proteins(rng, 1024, 24, 64), card, "bench.py shape",
            32)
    err["align_grid"], grid_times, grid_launches = phase_e(
        rng, dev, M, card, args.seed)
    launches["align_grid"] = grid_launches["align_grid"]
    phase_f(dev, M, main_set, tiles_mat, card)
    phase_g(rng, dev, card)
    t0 = time.perf_counter()
    filter_s = phase_h(rng, dev, M, card)
    log(f"(h) phase seconds {time.perf_counter() - t0:.1f} on {card} "
        f"(filter {filter_s:.3f} s)")
    t0 = time.perf_counter()
    resume_s = phase_i(rng, dev, M, main_set, tiles_mat, card)
    log(f"(i) phase seconds {time.perf_counter() - t0:.1f} on {card} "
        "(cut, resumed run): " + ", ".join(
            f"{k} {a:.3f} s, {b:.3f} s" for k, (a, b) in resume_s.items()))
    t0 = time.perf_counter()
    phase_j(dev, M, main_set, tiles_mat, card)
    log(f"(j) phase seconds {time.perf_counter() - t0:.1f} on {card}")
    t0 = time.perf_counter()
    phase_k(rng, M, main_set, tiles_mat, card)
    log(f"(k) phase seconds {time.perf_counter() - t0:.1f} on {card}")
    t0 = time.perf_counter()
    phase_l(dev, M, main_set, tiles_mat, card)
    log(f"(l) phase seconds {time.perf_counter() - t0:.1f} on {card}")
    # ms / plain_ms / bound_ms: GA at (b)'s multi-tile shape (one launch as
    # the engine sends a combo) for the tile kernel, at (b)'s multi-band 160
    # shape for the per-pair kernel and at (e)'s 80 x 70 shape for the grid
    # kernel.  No PyTorch call computes an alignment score: library_ms null.
    shape_times = {"align_tiles": times[("align_tiles", "multi-tile 512x320")],
                   "align_pairs": times[("align_pairs", "multi-band 160")],
                   "align_grid": grid_times}
    kernels = []
    for name, (t_k, t_p, b, by) in shape_times.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t_k, "plain_ms": t_p,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
