"""Multi-host runs of the port (parallel/multihost.py and the engine's
partition/merger), on the CPU, mirroring tests/test_parallel.py: the
striped hosts cover the pair space once, merged runs reproduce the
one-host matrix bit for bit, every host reaches the same flush points, and
two real processes over gloo (library and CLI) end with the one-process
result."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sequencealigner_tpu import cli as ref_cli
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu_torch import checkpoint as ckpt
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.parallel.multihost import (
    TripletMerger, pack_triplets,
)

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)
#: Seconds a child process may take, start-up and peers' waits included.
DEADLINE = 300


def _two_bucket_set():
    """The 210-sequence two-bucket set of tests/test_torch_engine.py."""
    rng = np.random.default_rng(21)
    return SequenceSet.from_list(
        [rng.choice(AA, int(n)) for n in
         np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]], M.lut)


def _matrix(store):
    return np.asarray(store.matrix).reshape(store.dim, store.dim)


def _engine(monkeypatch, outer, algo="ga", gaps=GAPS):
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    return port_engine.Engine(algo, M.matrix, gaps, device="cpu")


class Recording:
    """A merger that keeps every call's triplets and returns them unmerged."""

    def __init__(self):
        self.calls = []

    def __call__(self, i, j, s):
        self.calls.append((i.copy(), j.copy(), s.copy()))
        return i, j, s


@pytest.mark.parametrize("outer", ["1", "0"])
@pytest.mark.parametrize("nhosts", [2, 3])
def test_partitioned_union_equals_full(monkeypatch, nhosts, outer):
    """tests/test_parallel.py:37: the hosts' stores do not overlap, their
    union is the one-host matrix and their pairs add up to all pairs."""
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 2048)
    ss = _two_bucket_set()
    eng = _engine(monkeypatch, outer)
    full = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, full, progress=False)
    merged = np.zeros((ss.num, ss.num), np.int32)
    covered = np.zeros((ss.num, ss.num), bool)
    total = 0
    for h in range(nhosts):
        st = OutputStore(ss.num, triangular=False, spill=False)
        s = eng.align_all(ss, st, progress=False, partition=(h, nhosts))
        assert s.pairs > 0
        total += s.pairs
        got = _matrix(st)
        mask = got != 0
        assert not (covered & mask).any()
        covered |= mask
        merged = np.where(mask, got, merged)
    assert total == stats.pairs
    np.testing.assert_array_equal(merged, _matrix(full))


def test_triplet_merger_exchanges_union():
    """tests/test_parallel.py:76, with the port's TripletMerger."""
    i0, j0, s0 = (np.array([1, 2], np.int64), np.array([3, 4], np.int64),
                  np.array([10, 20], np.int32))
    # int64-range indices must survive the int32-word packing
    i1, j1, s1 = (np.array([1 << 40], np.int64), np.array([6], np.int64),
                  np.array([-30], np.int32))

    def gather(x):
        if x.dtype == np.int64 and len(x) == 1:  # word-count exchange
            return np.array([[5 * 2], [5 * 1]])
        return np.stack([x, pack_triplets(i1, j1, s1, len(x))])

    m = TripletMerger(2, gather=gather)
    gi, gj, gs = m(i0, j0, s0)
    np.testing.assert_array_equal(gi, [1, 2, 1 << 40])
    np.testing.assert_array_equal(gj, [3, 4, 6])
    np.testing.assert_array_equal(gs, [10, 20, -30])
    assert m.calls == 1 and m.bytes > 0


def test_triplet_merger_single_host_passthrough():
    """tests/test_parallel.py:98."""
    m = TripletMerger(1)
    i = np.array([1], np.int64)
    j = np.array([2], np.int64)
    s = np.array([3], np.int32)
    gi, gj, gs = m(i, j, s)
    assert gi is i and gj is j and gs is s


@pytest.mark.parametrize("outer", ["1", "0"])
def test_partition_with_merger_completes_every_store(monkeypatch, outer):
    """tests/test_parallel.py:107: each host's triplets, handed to the other
    host's store as an all-gather would, complete both stores."""
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 2048)
    ss = _two_bucket_set()
    eng = _engine(monkeypatch, outer, "nw", (-4, 0, 0))
    full = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, full, progress=False)
    stores, recs = [], []
    for h in range(2):
        st = OutputStore(ss.num, triangular=False, spill=False)
        rec = Recording()
        eng.align_all(ss, st, progress=False, partition=(h, 2), merger=rec)
        stores.append(st)
        recs.append(rec)
    for h, st in enumerate(stores):
        for i, j, s in recs[1 - h].calls:
            if len(s):
                st.fill_pairs(i, j, s)
        np.testing.assert_array_equal(_matrix(st), _matrix(full))


def _short_set():
    """700 proteins of 4-14 and 200 of 20-30: two buckets of many short
    tiles (cheap on the CPU), so flush bounds of a few tiles fall between
    launch groups of different hosts."""
    rng = np.random.default_rng(4)
    return SequenceSet.from_list(
        [rng.choice(AA, int(n)) for n in
         np.r_[rng.integers(4, 15, 700), rng.integers(20, 31, 200)]], M.lut)


@pytest.mark.parametrize("outer", ["1", "0"])
@pytest.mark.parametrize("nhosts", [2, 3])
def test_every_host_reaches_the_same_flush_points(monkeypatch, nhosts,
                                                  outer):
    """Under a merger the flush points are a function of the global block
    stream: every host makes the same number of merger calls, empty ones
    included, whatever it owns.  (The eager flush of an idle flusher, and
    the pre-flush of a tile group that would cross the bound, depend on
    ownership: either one under a merger gives hosts different counts at
    these bounds.)"""
    ss = _short_set()
    eng = _engine(monkeypatch, outer)
    for bound in (2 * 16384, 3 * 16384):
        monkeypatch.setattr(port_engine, "FLUSH_PAIRS", bound)
        counts = []
        for h in range(nhosts):
            rec = Recording()
            eng.align_all(ss, None, progress=False, partition=(h, nhosts),
                          merger=rec)
            counts.append(len(rec.calls))
        assert len(set(counts)) == 1 and counts[0] > 2, (bound, counts)


def test_resumed_blocks_recontributed_to_merger(tmp_path, monkeypatch):
    """tests/test_parallel.py:204: blocks skipped through the journal still
    reach the merger, read back from the persistent store."""
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 2048)
    ss = _two_bucket_set()
    eng = _engine(monkeypatch, "1")
    full = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, full, progress=False)
    want = _matrix(full)
    header = ckpt.config_fingerprint(
        algo="ga", gaps=GAPS, matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=False,
        schedule=eng.schedule_token(ss.lengths),
    )
    spath, jpath = tmp_path / "h0.scores", tmp_path / "h0.ckpt"
    runs = []
    for _ in range(2):
        st = OutputStore(ss.num, triangular=False, spill=False,
                         persist_path=spath)
        journal = ckpt.Journal(jpath, header)
        rec = Recording()
        stats = eng.align_all(ss, st, progress=False, partition=(0, 2),
                              merger=rec, journal=journal)
        journal.close()
        runs.append((stats, rec))
    (first, rec0), (second, rec1) = runs
    assert first.pairs > 0 and second.pairs == 0
    assert second.pairs_resumed == first.pairs
    assert sum(len(s) for _, _, s in rec1.calls) == first.pairs
    for i, j, s in rec1.calls:
        np.testing.assert_array_equal(s, want[i, j])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_hosts(argv, nhosts=2, **extra_env):
    """``argv`` as ``nhosts`` processes under the multi-host environment
    (a free coordinator port, PYTHONPATH at the repository, ``extra_env``);
    each must exit 0 within DEADLINE seconds.  Returns their outputs."""
    port = _free_port()
    procs = []
    for h in range(nhosts):
        env = dict(os.environ, **extra_env, PYTHONPATH=str(REPO),
                   SEQALIGN_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SEQALIGN_TPU_NUM_PROCESSES=str(nhosts),
                   SEQALIGN_TPU_PROCESS_ID=str(h), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from sequencealigner_tpu_torch import matrices
    from sequencealigner_tpu_torch.engine import Engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.io.output import OutputStore
    from sequencealigner_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    host, nhosts = multihost.init_from_env(timeout=240)
    m = matrices.get("blosum62")
    rng = np.random.default_rng(1)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    seqs = [rng.choice(aa, int(rng.integers(4, 30))) for _ in range(150)]
    ss = SequenceSet.from_list(seqs, m.lut)
    store = OutputStore(ss.num, triangular=False, spill=False)
    merger = multihost.TripletMerger(nhosts)
    stats = Engine("ga", m.matrix, (0, -10, -1), device="cpu").align_all(
        ss, store, progress=False, partition=(host, nhosts), merger=merger)
    np.save(sys.argv[1] + f"/mh_{host}.npy",
            np.asarray(store.matrix).reshape(ss.num, ss.num))
    print("host", host, "of", nhosts, "pairs", stats.pairs, "merges",
          merger.calls)
""")


def test_two_process_gloo_merge(tmp_path):
    """Two real processes join over gloo through init_from_env's
    environment, score their stripes and merge at every flush: both stores
    equal the one-process run."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    outs = _run_hosts([str(worker), str(tmp_path)],
                      SEQALIGN_TPU_FLUSH_PAIRS="2048")
    a, b = (np.load(tmp_path / f"mh_{h}.npy") for h in range(2))
    rng = np.random.default_rng(1)
    seqs = [rng.choice(AA, int(rng.integers(4, 30))) for _ in range(150)]
    ss = SequenceSet.from_list(seqs, M.lut)
    full = OutputStore(ss.num, triangular=False, spill=False)
    port_engine.Engine("ga", M.matrix, GAPS, device="cpu").align_all(
        ss, full, progress=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _matrix(full))
    pairs = [int(o.split("pairs")[1].split()[0]) for o in outs]
    merges = {o.split("merges")[1].split()[0] for o in outs}
    assert min(pairs) > 0 and sum(pairs) == ss.num * (ss.num - 1) // 2
    assert len(merges) == 1


def _h5(path):
    import h5py

    with h5py.File(path) as f:
        d = f["/similarity_matrix"]
        return list(f["/sequences"].asstr()), d[...], d.dtype, d.chunks


def test_cli_two_processes_write_the_reference_hdf5(tmp_path):
    """seqalign-torch -C -k as two hosts: host 0 writes the HDF5 that
    seqalign-tpu -C writes (compared through h5py), host 1 writes none,
    and each host keeps its own journal and score store (.h0, .h1)."""
    fa = REPO / "examples" / "peptides.fasta"
    args = ["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10", "-e",
            "1", "-C", "-F", "-P"]
    out = tmp_path / "torch.h5"
    ck = tmp_path / "run.ckpt"
    outs = _run_hosts(["-m", "sequencealigner_tpu_torch.cli", *args,
                       "-o", str(out), "-k", str(ck)])
    for h, o in enumerate(outs):
        assert f"Distributed: host {h} of 2" in o
    assert "Writing Output" in outs[0] and "Writing Output" not in outs[1]
    ref_out = tmp_path / "tpu.h5"
    assert ref_cli.run(args + ["-Q", "-o", str(ref_out)]) == 0
    (s1, m1, d1, c1), (s2, m2, d2, c2) = _h5(out), _h5(ref_out)
    assert s1 == s2 and d1 == d2 and c1 == c2
    np.testing.assert_array_equal(m1, m2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["run.ckpt.h0", "run.ckpt.h0.scores", "run.ckpt.h1",
                     "run.ckpt.h1.scores", "torch.h5", "tpu.h5"]
