"""The tile kernel's 16-bit form (csrc/align_dp.cu ``tiles_kernel16``) and
its predicate ``Engine._dp16_ok``.

On the CPU: a NumPy emulation of the 16-bit sweep's arithmetic (int16
lanes that wrap, the kernel's stand-in for SCORE_MIN, its pad rows and its
order of operations) is held to the plain version
(``torch_dp.align_tiles_plain``) on worst-case inputs at the predicate's
edge, and shown to differ past it, where an exact score leaves int16.  On
the card (``cuda``-marked, skipped without a CUDA device): the 16-bit form
equals the plain version and the int32 form, and the engine runs it
exactly where the predicate holds."""

import contextlib
import io
from unittest import mock

import numpy as np
import pytest
import torch

from sequencealigner_tpu_torch import engine, matrices, trace
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.ops import cuda_dp, geometry, oracle, torch_dp

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

PAD = geometry.PAD
KB = cuda_dp.KB
M = matrices.get("blosum62")

# ---------------------------------------------------------------------------
# The emulation.


def _wrap(x):
    """int16 two's complement of int64 values, as a halfword holds them."""
    return ((np.asarray(x, np.int64) + 32768) % 65536 - 32768).astype(
        np.int64)


def _add(a, b):
    return _wrap(a + b)


def _addmax(a, b, c):  # __viaddmax_s16x2 on one halfword
    return np.maximum(_add(a, b), c)


def _border(algo, k, gap, opn, slope):
    if algo == "nw":
        return k * gap
    if algo == "ga":
        return 0 if k == 0 else opn + (k - 1) * slope
    return 0


def emulate(ccodes, l1, kcodes, l2, rows, sub, gaps, algo):
    """Scores of P pairs as the 16-bit sweep forms them: ccodes (P, Wc)
    and kcodes (P, K) letter codes, l1 / l2 (P,) lengths, ``rows`` (P,)
    the DP rows the pair's thread sweeps (the longer of its two lanes'
    lengths, rounded up to a band); sub the (25, 25) padded matrix, whose
    PAD entries the kernel holds as 0.  Every add wraps in int16, as the
    s16x2 instructions do."""
    gap, opn, ext = (int(g) for g in gaps)
    slope = gap if algo == "nw" else max(opn, ext)
    sent = -32768 + abs(ext)
    sub = np.where((np.arange(25)[:, None] == PAD)
                   | (np.arange(25)[None, :] == PAD), 0, sub).astype(np.int64)
    P = len(l1)
    R = int(rows.max()) if P else 0
    C = int(l1.max()) if P else 0
    live = (l1 > 0) & (l2 > 0)
    ridx = np.arange(1, R + 1)
    krow = np.where(ridx[None, :] <= l2[:, None],
                    kcodes[:, :R] if kcodes.shape[1] >= R else np.pad(
                        kcodes, ((0, 0), (0, R - kcodes.shape[1])),
                        constant_values=PAD), PAD)
    H = _wrap(np.array([_border(algo, r, gap, opn, slope)
                        for r in range(R + 1)]))[None, :].repeat(P, 0)
    X = np.full((P, R + 1), sent, np.int64)
    best = np.zeros(P, np.int64)
    res = np.zeros(P, np.int64)
    counts = ridx[None, :] <= l2[:, None]
    for c in range(1, C + 1):
        letter = np.where(c <= l1, ccodes[:, min(c, ccodes.shape[1]) - 1],
                          PAD)
        s_col = sub[krow, letter[:, None]]  # (P, R)
        d = H[:, 0].copy()
        hu = _wrap(np.full(P, _border(algo, c, gap, opn, slope)))
        y = np.full(P, sent, np.int64)
        H[:, 0] = hu
        for r in range(1, R + 1):
            left = H[:, r].copy()
            dm = _add(d, s_col[:, r - 1])
            if algo == "nw":
                h = _addmax(left, gap, _addmax(hu, gap, dm))
            else:
                x = _addmax(left, opn, _add(X[:, r], ext))
                y = _addmax(hu, opn, _add(y, ext))
                h = np.maximum(np.maximum(dm, x), y)
                if algo == "sw":
                    h = np.maximum(h, 0)
                    on = counts[:, r - 1] & (c <= l1)
                    best = np.where(on, np.maximum(best, h), best)
                X[:, r] = x
            d = left
            H[:, r] = h
            hu = h
        if algo != "sw":
            at = H[np.arange(P), np.minimum(l2, R)]
            res = np.where(l1 == c, at, res)
    out = best if algo == "sw" else res
    return np.where(live, out, 0)


def emulate_tiles(desc, cwords, kmatT, klens, sub, gaps, algo):
    """``emulate`` over the pairs of tile launch (the plain version's
    arguments, as NumPy arrays): k-lanes 2u and 2u+1 of a tile share a
    thread, which sweeps to the longer of their lengths.  Returns (T,
    S_TILE, LANE) int64."""
    S, L = geometry.S_TILE, geometry.LANE
    cbytes = np.ascontiguousarray(cwords).view(np.uint8)[:, 4:]
    out = np.zeros((len(desc), S, L), np.int64)
    for t, (c0, kt) in enumerate(desc):
        crows = c0 + np.arange(S)
        lanes = kt * L + np.arange(L)
        l1 = np.repeat(cwords[crows, 0], L).astype(np.int64)
        l2 = np.tile(klens[0, lanes], S).astype(np.int64)
        pair = np.maximum(l2, np.tile(klens[0, lanes ^ 1], S))
        rows = -(-pair // KB) * KB
        cc = np.repeat(cbytes[crows], L, axis=0)
        kc = np.tile(kmatT[:, lanes].T, (S, 1))
        keep = (l1 > 0) & (rows > 0)
        got = np.zeros(S * L, np.int64)
        if keep.any():
            got[keep] = emulate(cc[keep], l1[keep], kc[keep], l2[keep],
                                rows[keep], sub, gaps, algo)
        out[t] = got.reshape(S, L)
    return out


# ---------------------------------------------------------------------------
# Worst cases at the predicate's edge.

#: The match letter (every run is made of it) and the mismatch letter.
HI, LO = 0, 1


def _matrix(step: int) -> np.ndarray:
    """A (24, 24) matrix whose largest |score| is ``step``: the match
    letter scores +step against itself, everything else -step."""
    m = np.full((24, 24), -step, np.int32)
    m[HI, HI] = step
    return m


def _tile(c_lens, k_lens, c_letter, k_letter, edge):
    """One tile launch (the plain version's arguments as NumPy arrays) of
    runs of one letter: c-rows of ``c_lens``, k-lanes of ``k_lens``, both
    buckets of edge ``edge``; a dummy descriptor row after the tile."""
    def bucket(lens, letter):
        mat = np.full((len(lens), edge), PAD, np.int8)
        for i, ln in enumerate(lens):
            mat[i, :ln] = letter
        return mat, np.asarray(lens, np.int32)

    cw = geometry.pack_bucket_outer(*bucket(c_lens, c_letter), edge)[0]
    _, kT, kl = geometry.pack_bucket_outer(*bucket(k_lens, k_letter), edge)
    dummy = cw.shape[0] - geometry.S_TILE
    return np.array([(0, 0), (dummy, 0)], np.int32), cw, kT, kl


def _plain(args, sub, gaps, algo):
    return torch_dp.align_tiles_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(sub),
        torch.tensor(gaps, dtype=torch.int32), algo=algo).numpy()


def _gaps(algo, step):
    return (-step, 0, 0) if algo == "nw" else (0, -step, -step)


#: The step at which two buckets of 128 sit on the predicate's edge:
#: (128 + 128 + KB + 1) * 113 = 32,657 <= 32,767, and 129 would not do.
EDGE, STEP = 128, 113
#: Lengths in adjacent k-lanes that differ (the shorter lane's pad rows
#: lie in the same band, an earlier band, or the whole sweep), a lane of
#: length 0, and the edge itself.
K_LENS = [EDGE, 97, 96, 33, 32, 31, 1, EDGE, 0, 64, 65, 127]
C_LENS = [EDGE, 127, 1, 64]


@pytest.mark.parametrize("case", ["top", "bottom"])
@pytest.mark.parametrize("algo", ["nw", "ga", "sw"])
def test_emulation_matches_plain_at_the_edge(algo, case):
    """At the predicate's edge the 16-bit sweep forms no value that leaves
    int16: W-runs against W-runs (the highest scores) and all-mismatch
    pairs whose gaps cost as much as a mismatch (the lowest), with PAD
    rows in the shorter lane of a pair."""
    gaps = _gaps(algo, STEP)
    eng = engine.Engine(algo, _matrix(STEP), gaps, device="cpu")
    assert eng._dp16_ok(EDGE, EDGE) and not eng._dp16_ok(EDGE, EDGE + 1)
    sub = engine.from_reference_inputs(_matrix(STEP), gaps, "cpu")[0].numpy()
    k_letter = HI if case == "top" else LO
    args = _tile(C_LENS, K_LENS, HI, k_letter, EDGE)
    want = _plain(args, sub, gaps, algo)
    got = emulate_tiles(*args, sub, gaps, algo)
    np.testing.assert_array_equal(got, want)
    if not (algo == "sw" and case == "bottom"):  # SW floors those at 0
        assert np.abs(want).max() > 0.4 * 32768


@pytest.mark.parametrize("algo", ["nw", "ga", "sw"])
def test_emulation_differs_past_the_edge(algo):
    """Past the edge the emulation goes wrong where an exact score leaves
    int16, so the test above has teeth: a 1-letter row against a gap run
    of 259 rows at a step of 127 (NW, GA: -32,893), and W-runs of 259
    (SW: 32,893)."""
    step, n = 127, 259
    gaps = _gaps(algo, step)
    eng = engine.Engine(algo, _matrix(step), gaps, device="cpu")
    edge = 264
    assert not eng._dp16_ok(edge, edge)
    sub = engine.from_reference_inputs(_matrix(step), gaps, "cpu")[0].numpy()
    c_lens = [n] if algo == "sw" else [1]
    args = _tile(c_lens, [n, n - 3], HI, HI if algo == "sw" else LO, edge)
    want = _plain(args, sub, gaps, algo)
    got = emulate_tiles(*args, sub, gaps, algo)
    assert abs(int(want[0, 0, 0])) > 32767
    assert got[0, 0, 0] != want[0, 0, 0]


@pytest.mark.parametrize("algo", ["nw", "ga", "sw"])
def test_emulation_matches_plain_on_blosum62(algo):
    """Random BLOSUM62 proteins of mixed lengths in two buckets, the
    reference's gaps: what the tiles cell's combos look like."""
    rng = np.random.default_rng(19)
    gaps = {"nw": (-4, 0, 0), "ga": (0, -10, -1), "sw": (0, -8, -2)}[algo]
    sub = engine.from_reference_inputs(M.matrix, gaps, "cpu")[0].numpy()
    edge = 96

    def bucket(count):
        lens = np.sort(rng.integers(0, edge + 1, count)).astype(np.int32)
        lens[-1] = edge
        mat = np.full((count, edge), PAD, np.int8)
        for i, ln in enumerate(lens):
            mat[i, :ln] = rng.integers(0, 20, ln)
        return mat, lens

    cw = geometry.pack_bucket_outer(*bucket(6), edge)[0]
    _, kT, kl = geometry.pack_bucket_outer(*bucket(40), edge)
    args = (np.array([(0, 0)], np.int32), cw, kT, kl)
    np.testing.assert_array_equal(emulate_tiles(*args, sub, gaps, algo),
                                  _plain(args, sub, gaps, algo))


def test_predicate_reads_edges_matrix_and_gaps():
    """_dp16_ok is a function of the bucket edges, the matrix's largest
    |score| and the gaps, and leaves _int16_ok (the output narrowing) as
    it was."""
    ga = engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    assert ga._dp16_ok(1024, 1024)  # the tiles cell: (2048 + 33) * 11
    assert ga._dp16_ok(1472, 1473) and not ga._dp16_ok(1473, 1473)
    assert not ga._dp16_ok(4096, 4096)
    assert ga._int16_ok(128, 128) and not ga._int16_ok(1024, 1024)
    wide = engine.Engine("ga", M.matrix, (0, -40, -1), device="cpu")
    assert wide._dp16_ok(256, 256) and not wide._dp16_ok(1024, 1024)
    big = engine.Engine("ga", M.matrix * 10, (0, -10, -1), device="cpu")
    assert not big._dp16_ok(1024, 1024)
    assert big._dp16_ok(128, 128)


def test_cpu_launch_reports_32_bits():
    """On the CPU align_tiles runs the plain version whatever ``dp16``
    says, and tells on_launch so."""
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 20, (5, 32)).astype(np.int8)
    lens = np.array([32, 20, 7, 1, 32], np.int32)
    cw = geometry.pack_bucket_outer(mat, lens, 32)[0]
    _, kT, kl = geometry.pack_bucket_outer(mat, lens, 32)
    sub, g = engine.from_reference_inputs(M.matrix, (0, -10, -1), "cpu")
    args = [torch.from_numpy(a) for a in (np.array([(0, 0)], np.int32), cw,
                                          kT, kl)]
    seen = []
    got = cuda_dp.align_tiles(*args, sub, g, algo="ga", dp16=True,
                              on_launch=lambda *a: seen.append(a))
    assert seen == [(1, 0.0, 32)]
    assert torch.equal(got, torch_dp.align_tiles_plain(*args, sub, g,
                                                       algo="ga"))


# ---------------------------------------------------------------------------
# On the card.

GAP_CASES = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -8, -2)),
             ("ga", (0, -1, -5)), ("sw", (0, -2, -7))]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _mixed_bucket(rng, count, edge):
    """Codes of ``count`` proteins up to ``edge`` in ascending length
    order, with a zero length, a length of 1, the edge, and neighbours
    that differ by a band."""
    lens = np.sort(rng.integers(0, edge + 1, count)).astype(np.int32)
    lens[0], lens[1], lens[-1] = 0, 1, edge
    lens[2:6] = (31, 32 + KB, 33, 33 + KB)  # unequal lanes of a pair
    mat = np.full((count, edge), PAD, np.int8)
    for i, ln in enumerate(lens):
        mat[i, :ln] = rng.integers(0, 20, ln)
    return mat, lens


@pytest.mark.cuda
@pytest.mark.parametrize("algo,gaps", GAP_CASES)
def test_dp16_matches_plain_and_int32_on_card(algo, gaps):
    """Full and partial tiles (k counts not a multiple of 128, dummy
    descriptor rows), paired lanes of unequal lengths and a zero-length
    lane: the 16-bit form, the int32 form and the plain version agree."""
    _needs_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    cmat, clens = _mixed_bucket(rng, 200, 160)
    kmat, klens = _mixed_bucket(rng, 150, 96)
    cw = geometry.pack_bucket_outer(cmat, clens, 160)[0]
    _, kT, kl = geometry.pack_bucket_outer(kmat, klens, 96)
    dummy = cw.shape[0] - geometry.S_TILE
    desc = np.array([(c0, kt) for kt in (1, 0) for c0 in (128, 0, 72)]
                    + [(dummy, 1), (dummy, 0)], np.int32)
    sub, g = engine.from_reference_inputs(M.matrix, gaps, dev)
    args = [torch.from_numpy(a).to(dev) for a in (desc, cw, kT, kl)]
    seen = []
    got = cuda_dp.align_tiles(*args, sub, g, algo=algo, dp16=True,
                              on_launch=lambda *a: seen.append(a))
    wide = cuda_dp.align_tiles(*args, sub, g, algo=algo)
    want = torch_dp.align_tiles_plain(*args, sub, g, algo=algo)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(wide, want)
    assert seen[0][2] == 16


def _engine_run(algo, gaps, seqs):
    """(matrix, the recorded run) of one Engine.align_all on the card."""
    eng = engine.Engine(algo, M.matrix, gaps, device="cuda:0")
    store = OutputStore(len(seqs), triangular=False, spill=False)
    with mock.patch.dict("os.environ", {"SEQALIGN_TPU_DEBUG_PHASES": "1"}), \
            contextlib.redirect_stdout(io.StringIO()):
        eng.align_all(SequenceSet.from_list(seqs, M.lut), store,
                      progress=False)
    n = len(seqs)
    return np.asarray(store.matrix).reshape(n, n), trace.runs()[-1]


def _proteins(rng, n, lo, hi):
    """n random proteins (uint8 letters) of lo..hi residues."""
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    return [rng.choice(letters, rng.integers(lo, hi + 1)) for _ in range(n)]


def _plain_scores(seqs, pairs, algo, gaps):
    """Scores of ``pairs`` (i, j) by the plain PyTorch sweep on the CPU."""
    codes = [M.lut[s].astype(np.int8) for s in seqs]
    width = max(len(c) for c in codes)

    def rows(idx):
        m = np.full((len(idx), width), PAD, np.int8)
        for r, k in enumerate(idx):
            m[r, :len(codes[k])] = codes[k]
        return torch.from_numpy(m), torch.tensor(
            [len(codes[k]) for k in idx], dtype=torch.int32)

    (ci, li), (ck, lk) = rows(pairs[:, 0]), rows(pairs[:, 1])
    sub, g = engine.from_reference_inputs(M.matrix, gaps, "cpu")
    return torch_dp.score_pairs(ci, li, ck, lk, sub, g, algo=algo).numpy()


@pytest.mark.cuda
def test_engine_runs_16_bits_on_card():
    """One align_all on the card: every tile launch ran at 16 bits, and
    sampled scores equal the oracle's."""
    _needs_cuda()
    rng = np.random.default_rng(5)
    seqs = _proteins(rng, 600, 10, 400)
    mat, run = _engine_run("ga", (0, -10, -1), seqs)
    tiles = [x for x in run.dp_launches if x.kernel == "align_tiles"]
    assert tiles and {x.bits for x in tiles} == {16}
    pairs = rng.integers(0, len(seqs), (400, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    np.testing.assert_array_equal(mat[pairs[:, 0], pairs[:, 1]],
                                  _plain_scores(seqs, pairs, "ga",
                                                (0, -10, -1)))
    codes = [M.lut[s] for s in seqs]
    for i, j in pairs[:4]:
        assert mat[i, j] == oracle.align_score(
            "ga", codes[i], codes[j], M.matrix, opn=-10, ext=-1)


@pytest.mark.cuda
def test_long_combo_runs_32_bits_on_card():
    """Buckets past the predicate (edges of 2,048 under BLOSUM62 GA 10/1:
    (2,048 + 2,048 + 33) * 11 > 32,767) keep the int32 form."""
    _needs_cuda()
    rng = np.random.default_rng(6)
    seqs = _proteins(rng, 160, 1900, 2048)
    mat, run = _engine_run("ga", (0, -10, -1), seqs)
    tiles = [x for x in run.dp_launches if x.kernel == "align_tiles"]
    assert tiles and {x.bits for x in tiles} == {32}
    pairs = np.array([(0, 1), (5, 150), (159, 80), (7, 100)])
    np.testing.assert_array_equal(mat[pairs[:, 0], pairs[:, 1]],
                                  _plain_scores(seqs, pairs, "ga",
                                                (0, -10, -1)))
