#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (sequencealigner_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0]

It builds the CUDA kernels from csrc/ and goes through four phases, each
printing its own lines; any failure raises, so the exit code is non-zero
and no result line is printed.

  (a) the card (nvidia-smi name and power limit), torch, the kernel build;
  (b) each kernel against its plain PyTorch version on the card, NW/GA/SW,
      BLOSUM62, at the main path's shapes (single-band edge 64, multi-band
      edge 160, a cross-bucket 256 x 96 combo, diagonal-remainder blocks
      with tail slots; random lengths including 1 and the edge, dummy
      descriptor rows), exact equality, plus CUDA-event timings of both;
  (c) the library align() on examples/peptides.fasta for NW/GA/SW against
      the NumPy oracle on every pair, and the seqalign-torch CLI (-W);
  (d) the main path at a size users run: 4096 proteins (lengths 50-500,
      20 residues, from --seed), GA BLOSUM62 open 10 extend 1, into a full
      OutputStore; wall time, pairs, cells and GCUPS; 32 sampled pairs
      against the oracle and 4096 against the plain version on the card;
      both kernels' launch counts, which are zeroed just before this run.
      Then the same at bench.py's shape (1024 proteins, lengths 24-64).

The second-to-last lines are the kernels' JSON record and the card's
nvidia-smi line; the last line is the JSON result.  It needs no network and
no JAX, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "sequencealigner_tpu_torch/csrc/align_dp.cu"
REPLACES = {
    "align_tiles": "sequencealigner_tpu/ops/pallas_dp.py:791",
    "align_pairs": "sequencealigner_tpu/ops/pallas_dp.py:724",
}
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -10, -1))]
RESIDUES = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (one warm-up call first)."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bucket(rng, count, edge):
    from sequencealigner_tpu_torch.ops.geometry import PAD

    lens = rng.integers(1, edge + 1, count).astype(np.int32)
    lens[0], lens[-1] = 1, edge
    mat = np.full((count, edge), PAD, np.int8)
    for i, ln in enumerate(lens):
        mat[i, :ln] = rng.integers(0, 20, ln)
    return mat, lens


def phase_b(rng, dev, M):
    """Kernel vs plain at the main path's shapes; returns the worst error
    per kernel and the GA timings at the multi-band shape."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.ops import cuda_dp, geometry, torch_dp
    from sequencealigner_tpu_torch.scheduler import TRI_W

    shapes = [("single-band 64", 64, 64), ("multi-band 160", 160, 160),
              ("cross 256x96", 256, 96), ("diag-tail 128", 128, 128)]
    err = {"align_tiles": 0, "align_pairs": 0}
    times = {}
    for label, Lc, Lk in shapes:
        cmat, clens = bucket(rng, 300, Lc)
        kmat, klens = bucket(rng, 200, Lk)
        cw = geometry.pack_bucket_outer(cmat, clens, Lc)[0]
        _, kT, kl = geometry.pack_bucket_outer(kmat, klens, Lk)
        dummy = cw.shape[0] - geometry.S_TILE
        desc = [(c0, kt) for kt in range(2) for c0 in range(0, 300, 128)]
        desc = np.array(desc + [(dummy, 0), (dummy, 1)], np.int32)
        targs = [torch.from_numpy(a).to(dev) for a in (desc, cw, kT, kl)]
        if Lc == Lk:  # the same-bucket diagonal remainder, tail window
            n_slots = 3 * TRI_W  # 300 rows: windows of 128, 128, 44
            lin = torch.arange(1 << (n_slots - 1).bit_length(), device=dev)
            rc, rk = engine._diag_rows(lin, n_slots, 300)
            mats = (cmat, cmat, clens, clens)
        else:
            rc = torch.from_numpy(rng.integers(0, 300, 8192).astype(np.int32))
            rk = torch.from_numpy(rng.integers(0, 200, 8192).astype(np.int32))
            rc, rk = rc.to(dev), rk.to(dev)
            mats = (cmat, kmat, clens, klens)
        mc, mk, lc, lk = (torch.from_numpy(a).to(dev) for a in mats)
        pargs = (mc, mk, rc, rk, lc, lk)
        for algo, gaps in ALGO_GAPS:
            sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
            for name, kern, plain, args in (
                ("align_tiles", cuda_dp.align_tiles,
                 torch_dp.align_tiles_plain, targs),
                ("align_pairs", cuda_dp.align_pairs,
                 torch_dp.align_pairs_plain, pargs),
            ):
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
                    times[(name, label)] = (t_k, t_p)
                    log(f"(b) {name:11s} {label:15s} GA  kernel {t_k:.4f} ms"
                        f"  plain {t_p:.4f} ms")
            log(f"(b) {label:15s} {algo}: both kernels == plain (exact)")
    return err, times


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
    r = subprocess.run(
        [sys.executable, "-m", "sequencealigner_tpu_torch.cli", "-i",
         "examples/peptides.fasta", "-m", "blosum62", "-a", "ga", "-s", "10",
         "-e", "1", "-W", "-F", "-P"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if r.returncode != 0:
        raise AssertionError(f"seqalign-torch failed:\n{r.stdout}{r.stderr}")
    log("(c) seqalign-torch -i examples/peptides.fasta -a ga -W -F: rc 0")


def phase_d(rng, dev, M, n, lo, hi, card, label, oracle_pairs):
    """The main path once at n sequences; returns (stats, launches)."""
    from sequencealigner_tpu_torch import engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore
    from sequencealigner_tpu_torch.ops import cuda_dp, oracle, torch_dp

    raw = [rng.choice(RESIDUES, int(rng.integers(lo, hi + 1)))
           for _ in range(n)]
    ss = SequenceSet.from_list(raw, M.lut)
    gaps = (0, -10, -1)
    eng = engine.Engine("ga", M.matrix, gaps, device=dev)
    store = OutputStore(n, triangular=False, spill=False)
    cuda_dp.align_tiles.launches = 0
    cuda_dp.align_pairs.launches = 0
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False)
    wall = time.perf_counter() - t0
    launches = {"align_tiles": cuda_dp.align_tiles.launches,
                "align_pairs": cuda_dp.align_pairs.launches}
    log(f"(d) {label}: {n} seqs, lengths {lo}-{hi}, GA BLOSUM62 10/1 on "
        f"{card}: wall {wall:.3f} s, align {stats.seconds:.3f} s, "
        f"{stats.pairs} pairs, {stats.cells} cells, "
        f"{stats.gcups:.2f} GCUPS, launches {launches}")
    if stats.pairs != n * (n - 1) // 2 or min(launches.values()) == 0:
        raise AssertionError(f"(d) {label}: pairs or launches wrong")
    mat = np.asarray(store.matrix).reshape(n, n)
    if (np.diag(mat) != 0).any() or not (mat == mat.T).all():
        raise AssertionError(f"(d) {label}: matrix not symmetric/zero diag")
    enc = [M.lut[s] for s in raw]
    i = rng.integers(0, n, 4096)
    j = (i + rng.integers(1, n, 4096)) % n
    for p in range(oracle_pairs):
        want = oracle.ga_affine(enc[i[p]], enc[j[p]], M.matrix, -10, -1)
        if mat[i[p], j[p]] != want:
            raise AssertionError(f"(d) {label}: pair {i[p]},{j[p]} != oracle")
    L = max(len(s) for s in raw)
    codes = np.full((n, L), 24, np.int8)
    for r, e in enumerate(enc):
        codes[r, : len(e)] = e
    lens = torch.from_numpy(ss.lengths).to(dev)
    ct = torch.from_numpy(codes).to(dev)
    sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
    it = torch.from_numpy(i.astype(np.int32)).to(dev)
    jt = torch.from_numpy(j.astype(np.int32)).to(dev)
    plain = torch_dp.align_pairs_plain(ct, ct, it, jt, lens, lens, sub, g,
                                       algo="ga").cpu().numpy()
    if (plain != mat[i, j]).any():
        raise AssertionError(f"(d) {label}: sampled pairs != plain version")
    log(f"(d) {label}: {oracle_pairs} sampled pairs == oracle, 4096 sampled "
        "pairs == plain version on the card")
    return stats, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sequencealigner_tpu_torch import matrices
    from sequencealigner_tpu_torch.ops import cuda_dp

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
    _, launches = phase_d(rng, dev, M, 4096, 50, 500, card, "main", 32)
    phase_d(rng, dev, M, 1024, 24, 64, card, "bench.py shape", 32)
    kernels = []
    for name in ("align_tiles", "align_pairs"):
        t_k, t_p = times[(name, "multi-band 160")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t_k, "plain_ms": t_p,
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
