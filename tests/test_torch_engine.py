"""The port's engine, library entry and CLI against the JAX package's, on the
CPU: full score matrices and HDF5 files must be equal, not close."""

from pathlib import Path

import numpy as np
import pytest
import torch

import sequencealigner_tpu as ref_pkg
import sequencealigner_tpu_torch as port_pkg
from sequencealigner_tpu import cli as ref_cli
from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu_torch import cli as port_cli
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
M = ref_matrices.get("blosum62")
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -9, -2))]


def _two_bucket_seqs():
    """140 short + 70 longer proteins: two buckets that survive the merge
    policy, so cross-bucket tiles, same-bucket below-diagonal tiles and the
    diagonal remainder (140 rows span two 128-row windows) all run (the
    set of tests/test_engine.py's engine-level tile test)."""
    rng = np.random.default_rng(21)
    return [
        rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), int(ln)).astype(np.uint8)
        for ln in np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]
    ]


def _port_matrix(seqs, algo, gaps):
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = port_engine.Engine(algo, M.matrix, gaps, device="cpu")
    store = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, store, progress=False)
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    return np.asarray(store.matrix).reshape(ss.num, ss.num), eng, ss


@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
def test_engine_matches_reference_tile_engine(algo, gaps):
    """The port's CPU engine == the JAX engine on its tile path (Pallas
    interpreter), matrix for matrix, with the same schedule token."""
    seqs = _two_bucket_seqs()
    got, eng, ss = _port_matrix(seqs, algo, gaps)
    ref = ref_engine.Engine(
        algo, M.matrix, gaps, device_kind="cpu", use_pallas=True,
        pallas_interpret=True,
    )
    rss = RefSequenceSet.from_list(seqs, M.lut)
    store = RefOutputStore(rss.num, triangular=False, spill=False)
    ref.align_all(rss, store, progress=False)
    want = np.asarray(store.matrix).reshape(rss.num, rss.num)
    np.testing.assert_array_equal(got, want)
    token = eng.schedule_token(ss.lengths)
    assert token.startswith("tiles-v2") and token == ref.schedule_token(
        rss.lengths
    )


@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
def test_library_align_matches_reference_on_peptides(algo, gaps):
    """align() of both packages on examples/peptides.fasta, on the CPU."""
    seqs = [
        line.strip() for line in (EXAMPLES / "peptides.fasta").read_text()
        .splitlines() if line.strip() and not line.startswith(">")
    ]
    kw = dict(algo=algo, gap=-gaps[0], open=-gaps[1], extend=-gaps[2])
    got = port_pkg.align(seqs, device="cpu", **kw)
    want = ref_pkg.align(seqs, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


def test_stats_count_every_cell_once_and_cache_buckets():
    """A second run on the same set reuses the uploaded buckets and gives
    the same matrix; stats count every pair and true cell once."""
    seqs = _two_bucket_seqs()
    first, eng, ss = _port_matrix(seqs, "ga", (0, -10, -1))
    cached = eng._bucket_cache[1]
    store = OutputStore(ss.num, triangular=True, spill=False)
    stats = eng.align_all(ss, store, progress=True)
    assert eng._bucket_cache[1] is cached
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    lengths = ss.lengths.astype(np.int64)
    assert stats.cells == (lengths.sum() ** 2 - (lengths**2).sum()) // 2
    np.testing.assert_array_equal(store.rows(0, ss.num), first)
    counted = eng.align_all(ss, None, progress=False)  # the CLI's -W run
    assert (counted.pairs, counted.cells) == (stats.pairs, stats.cells)


def test_schedule_token_matches_reference():
    rng = np.random.default_rng(8)
    ref = ref_engine.Engine(
        "ga", M.matrix, (0, -10, -1), device_kind="cpu", use_pallas=True,
    )
    port = port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    for hi in (40, 700, 5000):
        lengths = rng.integers(1, hi, 500)
        assert port.schedule_token(lengths) == ref.schedule_token(lengths)


def _h5(path):
    import h5py

    with h5py.File(path) as f:
        d = f["/similarity_matrix"]
        return list(f["/sequences"].asstr()), d[...], d.dtype, d.chunks


CLI_INPUTS = [
    ("peptides.fasta", ["-m", "blosum62", "-a", "ga", "-s", "10", "-e", "1"]),
    ("dna.csv", ["-m", "nuc44", "-a", "sw", "-s", "10", "-e", "1"]),
]


@pytest.mark.parametrize("inp,args", CLI_INPUTS)
def test_cli_writes_the_reference_hdf5(tmp_path, inp, args):
    """seqalign-torch -C and seqalign-tpu -C write equal HDF5 files:
    sequences, matrix contents, dtype and chunking."""
    outs = []
    for name, cli in (("torch", port_cli), ("tpu", ref_cli)):
        out = tmp_path / f"{name}.h5"
        rc = cli.run(["-i", str(EXAMPLES / inp), "-o", str(out), *args,
                      "-C", "-F", "-Q", "-P"])
        assert rc == 0, name
        outs.append(_h5(out))
    (s1, m1, d1, c1), (s2, m2, d2, c2) = outs
    assert s1 == s2 and d1 == d2 and c1 == c2
    np.testing.assert_array_equal(m1, m2)


def test_cli_no_write_runs(capsys):
    """-W: the alignment runs and is counted, nothing is written."""
    rc = port_cli.run(["-i", str(EXAMPLES / "peptides.fasta"), "-W", "-m",
                       "blosum62", "-a", "ga", "-s", "10", "-e", "1", "-C",
                       "-F", "-P", "-B"])
    assert rc == 0
    assert "Alignments per second" in capsys.readouterr().out


@pytest.mark.parametrize("inp,args,thr", [
    (*CLI_INPUTS[0], "0.9"), (*CLI_INPUTS[1], "0.9"),
    (*CLI_INPUTS[0], "0.2"), (*CLI_INPUTS[1], "0.4"),
])
def test_cli_filter_writes_the_reference_hdf5(tmp_path, inp, args, thr,
                                              capsys):
    """seqalign-torch -C -f and seqalign-tpu -C -f drop the same sequences
    ("Filtered out N": none at 0.9 on these files, 8 of peptides.fasta at
    0.2, 4 of dna.csv at 0.4) and write equal HDF5 files."""
    outs, lines = [], []
    for name, cli in (("torch", port_cli), ("tpu", ref_cli)):
        out = tmp_path / f"{name}.h5"
        rc = cli.run(["-i", str(EXAMPLES / inp), "-o", str(out), *args,
                      "-f", thr, "-C", "-F", "-P"])
        assert rc == 0, name
        outs.append(_h5(out))
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if "Filtered out" in ln])
    assert len(lines[0]) == 1 and lines[0] == lines[1]
    (s1, m1, d1, c1), (s2, m2, d2, c2) = outs
    assert s1 == s2 and d1 == d2 and c1 == c2
    np.testing.assert_array_equal(m1, m2)


def test_cli_checkpoint_resume(tmp_path, capsys):
    """-k twice: the second run resumes every block from the journal and
    writes the same HDF5 (the reference's tests/test_cli_checkpoint_resume
    in tests/test_checkpoint.py)."""
    ck = tmp_path / "run.ckpt"
    base = ["-i", str(EXAMPLES / "peptides.fasta"), "-m", "blosum62", "-a",
            "ga", "-s", "10", "-e", "1", "-F", "-P", "-C", "-k", str(ck)]
    assert port_cli.run(base + ["-o", str(tmp_path / "o1.h5")]) == 0
    assert "Resuming" not in capsys.readouterr().out
    assert port_cli.run(base + ["-o", str(tmp_path / "o2.h5")]) == 0
    assert "Resuming:" in capsys.readouterr().out
    assert (tmp_path / "run.ckpt.scores").exists()
    (s1, m1, _, _), (s2, m2, _, _) = (_h5(tmp_path / "o1.h5"),
                                      _h5(tmp_path / "o2.h5"))
    assert s1 == s2
    np.testing.assert_array_equal(m1, m2)


def test_cli_trace_flag(tmp_path):
    """-t DIR writes a torch.profiler trace of the alignment phase."""
    tdir = tmp_path / "trace"
    rc = port_cli.run(["-i", str(EXAMPLES / "peptides.fasta"), "-o",
                       str(tmp_path / "o.h5"), "-m", "blosum62", "-a", "nw",
                       "-p", "4", "-F", "-P", "-Q", "-C", "-t", str(tdir)])
    assert rc == 0
    traces = list(tdir.glob("*.json"))
    assert traces and all(t.stat().st_size > 0 for t in traces)


def test_cli_refuses_cpu_without_c_or_cuda(tmp_path, monkeypatch, capsys):
    """No CUDA device and no -C: the warning, then the reference's prompt.
    -F answers yes and the run goes on on the CPU; "n" on stdin refuses
    and exits 1."""
    import io

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-i", str(EXAMPLES / "peptides.fasta"), "-m", "blosum62",
            "-a", "nw", "-p", "4", "-P"]
    out = tmp_path / "o.h5"
    assert port_cli.run(argv + ["-o", str(out), "-F"]) == 0
    got = capsys.readouterr()
    assert "No CUDA device found" in got.out + got.err
    (_, m, _, _) = _h5(out)
    ref_out = tmp_path / "ref.h5"
    assert ref_cli.run(argv + ["-o", str(ref_out), "-C", "-F", "-Q"]) == 0
    np.testing.assert_array_equal(m, _h5(ref_out)[1])
    monkeypatch.setattr("sys.stdin", io.StringIO("n\n"))
    assert port_cli.run(argv + ["-W"]) == 1
    got = capsys.readouterr()
    assert "Do you want to use the CPU instead?" in got.out
    assert "Failed to initialize CUDA device" in got.err
