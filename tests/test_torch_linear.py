"""The port's linear-v1 schedule against the JAX package's, on the CPU:
SEQALIGN_TPU_OUTER=0, buckets wider than W_MAX (long sequences) and
matrices with |score| > 127.  Matrices, schedule tokens and the (start,
width) block stream of every combo must be equal, not close.

The reference engine runs on a one-device CPU mesh with its Pallas kernels
in interpret mode (and its XLA path where it routes long combos), so both
engines size blocks for one device.  SEQALIGN_TPU_OUTER is read when an
engine is built: the tests set it before building either.
"""

import numpy as np
import pytest
import torch

from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu import scheduler as ref_scheduler
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu.ops import oracle as ref_oracle
from sequencealigner_tpu.ops import pallas_dp
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch import scheduler
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.ops import cuda_dp, geometry

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -9, -2))]
AMINO = list(b"ARNDCQEGHILKMFPSTWYV")


def _seqs(seed, short, long_lengths):
    """140 short proteins (10-16) plus proteins drawn from long_lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.r_[rng.integers(10, 17, short), long_lengths(rng)]
    return [rng.choice(AMINO, int(n)).astype(np.uint8) for n in lengths]


def _two_bucket_seqs():
    """The two-bucket set of tests/test_torch_engine.py (edges 16 and 64)."""
    return _seqs(21, 140, lambda rng: rng.integers(50, 65, 70))


def _record_blocks(monkeypatch, cls):
    """Record (a, b, start, width) of every block the engine takes from
    ``cls.blocks`` (a scheduler's linear-v1 block stream)."""
    seen = []
    orig = cls.blocks

    def blocks(self, a, b, *args, **kw):
        for blk in orig(self, a, b, *args, **kw):
            seen.append((a, b, blk.start, blk.width))
            yield blk

    monkeypatch.setattr(cls, "blocks", blocks)
    return seen


def _port_run(seqs, algo, gaps, matrix=M, target_cells=None, **kw):
    ss = SequenceSet.from_list(seqs, matrix.lut)
    eng = port_engine.Engine(algo, matrix.matrix, gaps, device="cpu",
                             target_cells=target_cells)
    store = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, store, progress=False, **kw)
    mat = np.asarray(store.matrix).reshape(ss.num, ss.num)
    return mat, eng.schedule_token(ss.lengths), stats


def _ref_run(seqs, algo, gaps, target_cells=None, matrix=M):
    ref = ref_engine.Engine(
        algo, matrix.matrix, gaps, mesh=ref_engine.make_mesh("cpu", 1),
        use_pallas=True, pallas_interpret=True, target_cells=target_cells,
    )
    rss = RefSequenceSet.from_list(seqs, M.lut)
    store = RefOutputStore(rss.num, triangular=False, spill=False)
    ref.align_all(rss, store, progress=False)
    mat = np.asarray(store.matrix).reshape(rss.num, rss.num)
    return mat, ref.schedule_token(rss.lengths)


def _compare_with_reference(monkeypatch, seqs, algo, gaps,
                            target_cells=None, matrix=M):
    port_seen = _record_blocks(monkeypatch, scheduler.Schedule)
    ref_seen = _record_blocks(monkeypatch, ref_scheduler.Schedule)
    got, token, stats = _port_run(seqs, algo, gaps, matrix=matrix,
                                  target_cells=target_cells)
    want, ref_token = _ref_run(seqs, algo, gaps, matrix=matrix,
                               target_cells=target_cells)
    np.testing.assert_array_equal(got, want)
    assert token.startswith("linear-v1") and token == ref_token
    assert port_seen and port_seen == ref_seen
    assert stats.pairs == len(seqs) * (len(seqs) - 1) // 2
    return port_seen


@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
def test_linear_engine_matches_reference(monkeypatch, algo, gaps):
    """SEQALIGN_TPU_OUTER=0: the port's linear-v1 run == the JAX engine's
    per-pair run (align_packed, interpret mode) on two buckets: same
    matrix, token and block stream (tri and rect combos, tail blocks)."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", "0")
    _compare_with_reference(monkeypatch, _two_bucket_seqs(), algo, gaps)


@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
def test_long_bucket_route_matches_reference(monkeypatch, algo, gaps):
    """A bucket wider than W_MAX (patched to 64 in both packages, so an
    edge-96 bucket is 'long') sends the whole run to linear-v1: its long
    combos take the target-cells block widths (the reference's XLA path),
    the short one the kernel's stripes."""
    monkeypatch.setattr(geometry, "W_MAX", 64)
    monkeypatch.setattr(pallas_dp, "W_MAX", 64)
    seqs = _seqs(5, 140, lambda rng: rng.integers(70, 91, 70))
    _compare_with_reference(monkeypatch, seqs, algo, gaps)


@pytest.mark.parametrize("route", ["long", "wide"])
def test_target_cells_sizes_blocks_as_the_reference(monkeypatch, route):
    """Engine(target_cells=2^12) sizes the blocks of the combos the tile
    geometry does not take as the reference's engine with the same
    target_cells does (same matrix, token and block stream), in more
    blocks than the default of 2^24 cells: a long bucket (edge 96 with
    W_MAX patched to 64 in both packages, as above), or BLOSUM62 x 20."""
    matrix = M
    if route == "long":
        for mod in (geometry, pallas_dp):
            monkeypatch.setattr(mod, "W_MAX", 64)
        seqs = _seqs(5, 140, lambda rng: rng.integers(70, 91, 30))
    else:
        matrix = _Wide(20)
        seqs = _two_bucket_seqs()
    small = _compare_with_reference(monkeypatch, seqs, "ga", (0, -10, -1),
                                    target_cells=1 << 12, matrix=matrix)
    default = _record_blocks(monkeypatch, scheduler.Schedule)
    _port_run(seqs, "ga", (0, -10, -1), matrix=matrix)
    assert len(small) > len(default)


def _oracle_check(seqs, matrix, algo, gaps, mat, pairs):
    lut = M.lut
    for i, j in pairs:
        want = ref_oracle.align_score(
            algo, lut[seqs[j]], lut[seqs[i]], matrix, gap=gaps[0],
            opn=gaps[1], ext=gaps[2],
        )
        assert mat[i, j] == want, (i, j)


class _Wide:
    """BLOSUM62 scaled by ``k`` (the port's matrices module shape)."""

    def __init__(self, k):
        self.matrix = M.matrix.astype(np.int64) * k
        self.lut = M.lut


def test_wide_matrix_matches_oracle():
    """BLOSUM62 x 20 (|score| up to 220) runs through linear-v1, with GA
    scores beyond the int16 range, equal to the oracle."""
    rng = np.random.default_rng(3)
    base = rng.choice(list(b"WC"), 200).astype(np.uint8)
    seqs = []
    for n in rng.integers(150, 201, 10):
        s = base[:n].copy()
        s[rng.integers(0, n, 6)] = rng.choice(AMINO, 6)
        seqs.append(s)
    wide = _Wide(20)
    mat, token, stats = _port_run(seqs, "ga", (0, -10, -1), wide)
    assert token.startswith("linear-v1")
    assert mat.max() > 32767
    pairs = [(i, j) for i in range(10) for j in range(i + 1, 10)][::3]
    _oracle_check(seqs, wide.matrix, "ga", (0, -10, -1), mat, pairs)


def test_int16_bound_uses_the_matrix():
    """The int16 narrowing bound steps by max |sub|: with BLOSUM62 x 27
    (|score| up to 297) two 128-residue tryptophan runs score 38,016 in an
    edge-128 bucket, which a bound of 127 per step would narrow and wrap."""
    wide = _Wide(27)
    eng = port_engine.Engine("nw", wide.matrix, (-4, 0, 0), device="cpu")
    assert not eng._int16_ok(128, 128)
    narrow = port_engine.Engine("nw", M.matrix, (-4, 0, 0), device="cpu")
    assert narrow._int16_ok(128, 128)
    seqs = [np.full(128, ord("W"), np.uint8)] * 2 + [
        np.frombuffer(b"W" * 120 + b"A" * 8, np.uint8)
    ]
    mat, _, _ = _port_run(seqs, "nw", (-4, 0, 0), wide)
    assert mat[0, 1] == 128 * 11 * 27
    _oracle_check(seqs, wide.matrix, "nw", (-4, 0, 0), mat, [(0, 2), (1, 2)])


@pytest.mark.parametrize("outer", ["1", "0"])
def test_align_all_limit_pairs(monkeypatch, outer):
    """limit_pairs stops scheduling at a block boundary with consistent
    stats, in both schedules (cf. tests/test_engine.py limit_pairs)."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    ss = SequenceSet.from_list(_two_bucket_seqs(), M.lut)
    eng = port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    total = ss.num * (ss.num - 1) // 2
    stats = eng.align_all(ss, None, progress=False, limit_pairs=total // 3)
    assert total // 3 <= stats.pairs < total
    full = eng.align_all(ss, None, progress=False)
    assert full.pairs == total


def test_schedule_token_matches_reference_linear(monkeypatch):
    """Tokens equal the reference Pallas engine's in each linear-v1
    configuration: SEQALIGN_TPU_OUTER=0, edges beyond 4096, |score| > 127."""
    rng = np.random.default_rng(8)
    wide = M.matrix * 20

    def engines(matrix):
        return (
            ref_engine.Engine("ga", matrix, (0, -10, -1), device_kind="cpu",
                              use_pallas=True),
            port_engine.Engine("ga", matrix, (0, -10, -1), device="cpu"),
        )

    configs = [engines(M.matrix), engines(wide)]
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", "0")
    configs.append(engines(M.matrix))
    for ref, port in configs:
        for hi in (40, 700, 5000):
            lengths = rng.integers(1, hi, 500)
            assert port.schedule_token(lengths) == ref.schedule_token(lengths)
    ref, port = configs[0]
    assert port.schedule_token([100, 5000]).startswith("linear-v1")
    assert configs[1][1].schedule_token([10, 20]).startswith("linear-v1")
    assert configs[2][1].schedule_token([10, 20]).startswith("linear-v1")


@pytest.mark.parametrize("tri", [False, True])
def test_pair_rows_match_reference(tri):
    """The linear-v1 pair-id inversion equals the reference's on-device
    _pair_rows, pad ids past the combo included."""
    rows = 300 if tri else 70
    npairs = rows * (rows - 1) // 2 if tri else rows * 130
    width = 4096
    for t0 in (0, 12288, npairs - 100):
        lin = t0 + torch.arange(width, dtype=torch.int64)
        rc, rk = port_engine._pair_rows(lin, npairs, rows, tri)
        jrc, jrk = ref_engine._pair_rows(
            np.zeros(rows, np.int32), t0, npairs, Wloc=width,
            mode="tri" if tri else "rect", small=True,
        )
        np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))
        np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))


@pytest.mark.cuda
def test_linear_engine_matches_plain_on_card(monkeypatch):
    """linear-v1 on the card (kernel) == on the CPU (plain versions), for
    SEQALIGN_TPU_OUTER=0 and a wide matrix; run on a machine with an
    NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seqs = _two_bucket_seqs()
    ss = SequenceSet.from_list(seqs, M.lut)
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", "0")
    for matrix in (M.matrix, M.matrix * 20):
        mats = []
        for dev in ("cuda", "cpu"):
            eng = port_engine.Engine("ga", matrix, (0, -10, -1), device=dev)
            store = OutputStore(ss.num, triangular=False, spill=False)
            n0 = cuda_dp.align_pairs.launches
            eng.align_all(ss, store, progress=False)
            assert (cuda_dp.align_pairs.launches > n0) == (dev == "cuda")
            mats.append(np.asarray(store.matrix).copy())
        np.testing.assert_array_equal(*mats)
