"""Checkpoint/resume in the port: the journal copy, the engine's journal
hooks on the CPU, and resume across packages (a journal and score store
written by one package's engine, finished by the other's, bit for bit)."""

import json

import numpy as np
import pytest
import torch

from sequencealigner_tpu import checkpoint as ref_ckpt
from sequencealigner_tpu import cli as ref_cli
from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu_torch import checkpoint as ckpt
from sequencealigner_tpu_torch import cli as port_cli
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)
SENTINEL = -777


def _random_set(rng, n):
    seqs = [rng.choice(AA, int(rng.integers(4, 40))) for _ in range(n)]
    return SequenceSet.from_list(seqs, M.lut)


def _header(ss, algo="ga", gaps=GAPS, schedule="linear-v1"):
    return ckpt.config_fingerprint(
        algo=algo, gaps=gaps, matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True, schedule=schedule,
    )


def test_journal_roundtrip(tmp_path):
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 3, 5])
    j.commit([7])
    j.close()
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 3, 5, 7}
    j2.close()


def test_journal_rejects_config_mismatch(tmp_path):
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    ckpt.Journal(p, _header(ss)).close()
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, _header(ss, algo="sw"))


def test_persistent_array_survives(tmp_path):
    p = tmp_path / "scores.dat"
    a = ckpt.persistent_array(p, 16)
    a[3] = 42
    a.flush()
    del a
    assert ckpt.persistent_array(p, 16)[3] == 42


def test_journal_tolerates_torn_tail(tmp_path):
    """A crash mid-commit tears the last line: it is truncated, earlier
    commits stay."""
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 1])
    j.commit([2])
    j.close()
    with open(p, "a") as f:
        f.write("[7, 8")  # torn tail, no newline
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 1, 2}
    j2.commit([3])
    j2.close()
    assert ckpt.Journal(p, _header(ss)).done == {0, 1, 2, 3}


def test_journal_complete_line_without_newline_is_torn(tmp_path):
    """A complete JSON tail without its newline is discarded, so the next
    commit does not run onto it."""
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 1])
    j.close()
    with open(p, "a") as f:
        f.write("[5, 6]")
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 1}
    j2.commit([7, 8])
    j2.close()
    assert ckpt.Journal(p, _header(ss)).done == {0, 1, 7, 8}


def test_fingerprint_binds_sequence_content(tmp_path):
    ss = _random_set(np.random.default_rng(0), 8)
    data2 = ss.data.copy()
    data2[0] = data2[0] + 1 if data2[0] < 80 else data2[0] - 1
    kw = dict(algo="ga", gaps=GAPS, matrix="blosum62", num_seqs=ss.num,
              lengths=ss.lengths, triangular=True)
    h1 = ckpt.config_fingerprint(data=ss.data, **kw)
    h2 = ckpt.config_fingerprint(data=data2, **kw)
    assert h1 != h2
    p = tmp_path / "run.ckpt"
    ckpt.Journal(p, h1).close()
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, h2)


def test_journal_rejects_mid_file_corruption(tmp_path):
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0])
    j.close()
    lines = p.read_text().splitlines()
    lines.insert(1, "[5, 6")  # torn line NOT at the tail
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, _header(ss))


def test_schedule_mismatch_error_names_schedule(tmp_path):
    ss = _random_set(np.random.default_rng(0), 8)
    p = tmp_path / "run.ckpt"
    ckpt.Journal(p, _header(ss, schedule="tiles-v1")).close()
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.Journal(p, _header(ss, schedule="tiles-v2"))
    msg = str(ei.value)
    assert "schedule" in msg and "tiles-v1" in msg and "tiles-v2" in msg


def _two_bucket_seqs():
    """140 short + 70 longer proteins: two buckets, so tiles-v2 yields five
    blocks (tiles and diagonal-remainder blocks of three combos) and
    linear-v1 three superblocks, and a cut at half the pairs falls between
    blocks under both."""
    rng = np.random.default_rng(21)
    return [rng.choice(AA, int(n))
            for n in np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]]


def _port_engine(monkeypatch, outer):
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    return port_engine.Engine("ga", M.matrix, GAPS, device="cpu")


@pytest.mark.parametrize("outer", ["1", "0"])
def test_resume_completes_interrupted_run(tmp_path, monkeypatch, outer):
    """A journal cut to half its commit lines resumes to the full matrix:
    journaled blocks are skipped, the rest fill in."""
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 64)
    monkeypatch.setattr(port_engine, "SYNC_INTERVAL", 0.0)
    ss = SequenceSet.from_list(_two_bucket_seqs(), M.lut)
    eng = _port_engine(monkeypatch, outer)
    header = _header(ss, schedule=eng.schedule_token(ss.lengths))
    full = OutputStore(ss.num, triangular=True, spill=False)
    eng.align_all(ss, full, progress=False)

    jpath, spath = tmp_path / "run.ckpt", tmp_path / "run.scores"
    store1 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j1 = ckpt.Journal(jpath, header)
    eng.align_all(ss, store1, progress=False, journal=j1)
    j1.close()
    lines = jpath.read_text().splitlines()
    assert len(lines) >= 3
    jpath.write_text("\n".join(lines[: 1 + (len(lines) - 1) // 2]) + "\n")

    store2 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j2 = ckpt.Journal(jpath, header)
    assert j2.done
    stats = eng.align_all(ss, store2, progress=True, journal=j2)
    j2.close()
    assert stats.pairs_resumed > 0 and stats.pairs > 0
    assert stats.pairs + stats.pairs_resumed == ss.num * (ss.num - 1) // 2
    np.testing.assert_array_equal(np.asarray(store2.matrix),
                                  np.asarray(full.matrix))


def test_sync_interval_batches_commits(tmp_path, monkeypatch):
    """With a large SYNC_INTERVAL a many-flush run commits once (the final
    drain); with 0 every flush commits.  Both journal every block once and
    give equal stores."""
    ss = SequenceSet.from_list(_two_bucket_seqs(), M.lut)
    eng = port_engine.Engine("ga", M.matrix, GAPS, device="cpu")
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 64)

    def run(interval, tag):
        monkeypatch.setattr(port_engine, "SYNC_INTERVAL", interval)
        jpath = tmp_path / f"j_{tag}"
        store = OutputStore(ss.num, triangular=True, spill=False,
                            persist_path=tmp_path / f"s_{tag}")
        j = ckpt.Journal(jpath, _header(ss))
        eng.align_all(ss, store, progress=False, journal=j)
        j.close()
        ids = [json.loads(line) for line in jpath.read_text().splitlines()[1:]]
        flat = [x for line in ids for x in line]
        assert flat and len(flat) == len(set(flat))
        return len(ids), np.asarray(store.matrix).copy()

    n_batched, m1 = run(1e9, "batched")
    n_each, m2 = run(0.0, "each")
    assert n_batched == 1 and n_each > 1
    np.testing.assert_array_equal(m1, m2)


def _ref_engine():
    """The JAX engine on its tile / per-pair kernels (Pallas interpreter)
    on ONE device: its diagonal-remainder and superblock widths scale with
    the device count, and one device is the port's block stream."""
    return ref_engine.Engine(
        "ga", M.matrix, GAPS, mesh=ref_engine.make_mesh("cpu", 1),
        use_pallas=True, pallas_interpret=True,
    )


@pytest.mark.parametrize("outer", ["1", "0"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, monkeypatch, outer, writer):
    """One package's engine, cut by limit_pairs at about half the pairs,
    writes the journal and a sentinel-filled score store; the other's
    resumes them.  The matrix equals the full run bit for bit."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    for mod in (ref_engine, port_engine):
        monkeypatch.setattr(mod, "FLUSH_PAIRS", 1500)
        monkeypatch.setattr(mod, "SYNC_INTERVAL", 0.0)
    seqs = _two_bucket_seqs()
    n = len(seqs)
    total = n * (n - 1) // 2
    sides = {
        "jax": (_ref_engine(), RefSequenceSet.from_list(seqs, M.lut),
                RefOutputStore, ref_ckpt),
        "port": (port_engine.Engine("ga", M.matrix, GAPS, device="cpu"),
                 SequenceSet.from_list(seqs, M.lut), OutputStore, ckpt),
    }
    tokens = {k: e.schedule_token(ss.lengths) for k, (e, ss, _, _) in
              sides.items()}
    kind = "tiles-v2" if outer == "1" else "linear-v1"
    assert tokens["jax"] == tokens["port"] and tokens["port"].startswith(kind)

    full = OutputStore(n, triangular=True, spill=False)
    eng, ss, _, _ = sides["port"]
    eng.align_all(ss, full, progress=False)

    jpath, spath = tmp_path / "run.ckpt", tmp_path / "run.scores"
    pre = ckpt.persistent_array(spath, total)
    pre[:] = SENTINEL
    pre.flush()
    del pre
    resumer = "port" if writer == "jax" else "jax"
    for role, limit in ((writer, total // 2), (resumer, None)):
        eng, ss, store_cls, ck = sides[role]
        header = ck.config_fingerprint(
            algo="ga", gaps=GAPS, matrix="blosum62", num_seqs=n,
            lengths=ss.lengths, triangular=True, data=ss.data,
            schedule=tokens[role])
        store = store_cls(n, triangular=True, spill=False, persist_path=spath)
        journal = ck.Journal(jpath, header)
        stats = eng.align_all(ss, store, progress=False, journal=journal,
                              limit_pairs=limit)
        journal.close()
        if limit is not None:
            assert 0 < stats.pairs < total
            assert (np.asarray(store.matrix) == SENTINEL).any()
    assert stats.pairs_resumed > 0 and stats.pairs > 0
    assert stats.pairs + stats.pairs_resumed == total
    np.testing.assert_array_equal(np.asarray(store.matrix),
                                  np.asarray(full.matrix))


def test_cli_refuses_a_journal_of_the_reference_cpu_run(tmp_path, capsys):
    """seqalign-tpu -C schedules linear-v1 (its CPU engine runs the XLA
    path), seqalign-torch -C tiles-v2: the port refuses that journal,
    naming the schedule, and exits 1."""
    fa = tmp_path / "in.fasta"
    rng = np.random.default_rng(3)
    fa.write_text("".join(
        f">s{i}\n{rng.choice(AA, int(rng.integers(5, 30))).tobytes().decode()}\n"
        for i in range(12)))
    ck = tmp_path / "run.ckpt"
    base = ["-i", str(fa), "-m", "blosum62", "-a", "ga", "-s", "10", "-e",
            "1", "-F", "-P", "-Q", "-C", "-k", str(ck)]
    assert ref_cli.run(base + ["-o", str(tmp_path / "tpu.h5")]) == 0
    capsys.readouterr()
    assert port_cli.run(base + ["-o", str(tmp_path / "torch.h5")]) == 1
    err = capsys.readouterr().err
    assert "schedule" in err and "linear-v1" in err and "tiles-v2" in err
