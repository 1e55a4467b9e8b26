"""The port's copy of the sharded multi-host output
(sequencealigner_tpu_torch/parallel/shard_store.py), mirroring
tests/test_shard_store.py: row partition, per-host stores, shard HDF5 and
stitch, and two real processes routing triplets to their owners over TCP
while the port's engine scores their stripes."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch import matrices
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.parallel.shard_store import (
    RowPartition, ShardStore, stitch_shards, tri, write_shard,
)

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
M = matrices.get("blosum62")
#: Seconds a worker may take, its peer's start-up included.
DEADLINE = 300


def test_row_partition_tiles_and_balances():
    for dim, P in [(10, 2), (1000, 3), (100_000, 8), (1_000_000, 16)]:
        part = RowPartition(dim, P)
        b = part.bounds
        assert b[0] == 0 and b[-1] == dim
        assert (np.diff(b) >= 0).all()
        counts = [tri(int(b[k + 1])) - tri(int(b[k])) for k in range(P)]
        assert sum(counts) == tri(dim)
        ideal = tri(dim) / P
        for c in counts:
            assert abs(c - ideal) <= dim + 1
        j = np.arange(1, dim)
        o = part.owner_of(j)
        for k in range(P):
            lo, hi = part.rows_of(k)
            sel = (j >= lo) & (j < hi)
            assert (o[sel] == k).all()


def test_shard_store_fill_read_and_range_check():
    store = ShardStore(100, 30, 60)
    rng = np.random.default_rng(0)
    j = rng.integers(30, 60, 500).astype(np.int64)
    i = (rng.random(500) * j).astype(np.int64)
    s = rng.integers(-100, 100, 500).astype(np.int32)
    store.fill_pairs(i, j, s)
    want = {}
    for a, b, v in zip(i, j, s):
        want[(a, b)] = v
    ii = np.array([k[0] for k in want], np.int64)
    jj = np.array([k[1] for k in want], np.int64)
    np.testing.assert_array_equal(
        store.read_pairs(ii, jj), np.array(list(want.values()), np.int32)
    )
    with pytest.raises(ValueError):
        store.fill_pairs(np.array([1]), np.array([60]), np.array([1]))


def test_stitch_shards_reproduces_full_matrix(tmp_path):
    dim, P = 57, 3
    rng = np.random.default_rng(7)
    full = np.zeros((dim, dim), np.int32)
    iu = np.triu_indices(dim, 1)
    vals = rng.integers(-500, 500, len(iu[0])).astype(np.int32)
    full[iu] = vals
    full = full + full.T
    part = RowPartition(dim, P)
    paths = []
    for k in range(P):
        lo, hi = part.rows_of(k)
        sh = ShardStore(dim, lo, hi)
        jj = iu[1]
        sel = (jj >= lo) & (jj < hi)
        sh.fill_pairs(iu[0][sel], jj[sel], vals[sel])
        p = str(tmp_path / f"shard{k}.h5")
        write_shard(p, sh)
        paths.append(p)
    seqs = SequenceSet.from_list(
        [np.frombuffer(b"ARND", np.uint8)] * dim, M.lut
    )
    out = str(tmp_path / "out.h5")
    stitch_shards(paths, out, seqs)
    import h5py

    with h5py.File(out) as f:
        got = np.asarray(f["/similarity_matrix"])
        assert len(f["/sequences"]) == dim
    np.testing.assert_array_equal(got, full)


def _seqs():
    """300 proteins of 5-29: one bucket of three 128-row windows, so its
    tiles and diagonal-remainder blocks stripe over both hosts."""
    rng = np.random.default_rng(3)
    return [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                       int(rng.integers(5, 30))) for _ in range(300)]


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from sequencealigner_tpu_torch import matrices, ui
    from sequencealigner_tpu_torch.engine import Engine
    from sequencealigner_tpu_torch.io.input import SequenceSet
    from sequencealigner_tpu_torch.parallel.shard_store import (
        RowPartition, ShardStore, TripletRouter, write_shard,
    )

    torch.set_num_threads(1)
    host, nhosts, port0, port1, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        int(sys.argv[4]), sys.argv[5],
    )
    ui.configure(quiet=True)
    M = matrices.get("blosum62")
    rng = np.random.default_rng(3)
    seqs = [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                       int(rng.integers(5, 30))) for _ in range(300)]
    ss = SequenceSet.from_list(seqs, M.lut)
    part = RowPartition(ss.num, nhosts)
    addrs = [("127.0.0.1", port0), ("127.0.0.1", port1)]
    router = TripletRouter(host, nhosts, part, addrs, connect_timeout=240.0)
    lo, hi = part.rows_of(host)
    store = ShardStore(ss.num, lo, hi)
    eng = Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    stats = eng.align_all(ss, store, progress=False,
                          partition=(host, nhosts), merger=router)
    write_shard(f"{outdir}/shard{host}.h5", store)
    print(json.dumps(dict(
        host=host, pairs=stats.pairs, sent=router.bytes_sent,
        received=router.bytes_received, rounds=router.round,
        full_set_bytes=20 * ss.num * (ss.num - 1) // 2,
    )))
    router.close()
""")


def _free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_process_routed_shards_match_full_run(tmp_path):
    """Two real processes route triplets to their owners over TCP at every
    flush round; each holds only its row-range shard; the stitched output
    equals the one-process run bit for bit, both hosts scored pairs and ran
    the same rounds, and neither sent or received much more than half of
    the full triplet set."""
    ports = _free_ports(2)
    w = tmp_path / "worker.py"
    w.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               SEQALIGN_TPU_FLUSH_PAIRS="8192")
    procs = [
        subprocess.Popen(
            [sys.executable, str(w), str(h), "2", str(ports[0]),
             str(ports[1]), str(tmp_path)],
            cwd=str(REPO), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for h in range(2)
    ]
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
    stats = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                stats[d["host"]] = d
    assert set(stats) == {0, 1}
    ss = SequenceSet.from_list(_seqs(), M.lut)
    assert stats[0]["pairs"] > 0 and stats[1]["pairs"] > 0
    assert stats[0]["pairs"] + stats[1]["pairs"] == ss.num * (ss.num - 1) // 2
    assert stats[0]["rounds"] == stats[1]["rounds"] > 1
    full = OutputStore(ss.num, triangular=False, spill=False)
    port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu").align_all(
        ss, full, progress=False)
    want = np.asarray(full.matrix).reshape(ss.num, ss.num)
    out = str(tmp_path / "stitched.h5")
    stitch_shards(
        [str(tmp_path / "shard0.h5"), str(tmp_path / "shard1.h5")], out, ss
    )
    import h5py

    with h5py.File(out) as f:
        got = np.asarray(f["/similarity_matrix"])
    np.testing.assert_array_equal(got, want)
    full_bytes = stats[0]["full_set_bytes"]
    for h in (0, 1):
        assert stats[h]["sent"] < full_bytes // 2 + 4096
        assert stats[h]["received"] < full_bytes // 2 + 4096
