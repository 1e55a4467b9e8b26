"""The reference DP against a brute-force fill of the recurrences."""

import numpy as np
import pytest

from portbench.reference import dp, matrix
from portbench.tests.conftest import BENCH

NEG = -(1 << 40)


def pair_scores(algo, pairs, sub, gaps, **kw):
    """dp.scores of a list of (codes, codes) pairs."""
    seqs = [np.asarray(x, np.uint8) for p in pairs for x in p]
    offsets = np.r_[0, np.cumsum([len(x) for x in seqs])]
    k = np.arange(len(pairs))
    return dp.scores(algo, np.concatenate(seqs), offsets, 2 * k, 2 * k + 1,
                     sub, gaps, **kw)


def brute(algo, s1, s2, sub, gap, opn, ext):
    """Row-major fill of H, X, Y exactly as the recurrences read."""
    l1, l2 = len(s1), len(s2)
    H = [[0] * (l1 + 1) for _ in range(l2 + 1)]
    X = [[NEG] * (l1 + 1) for _ in range(l2 + 1)]
    Y = [[NEG] * (l1 + 1) for _ in range(l2 + 1)]
    for c in range(1, l1 + 1):
        if algo == "nw":
            H[0][c] = c * gap
        elif algo == "ga":
            X[0][c] = max(H[0][c - 1] + opn, X[0][c - 1] + ext)
            H[0][c] = X[0][c]
    for r in range(1, l2 + 1):
        if algo == "nw":
            H[r][0] = r * gap
        elif algo == "ga":
            Y[r][0] = max(H[r - 1][0] + opn, Y[r - 1][0] + ext)
            H[r][0] = Y[r][0]
    best = 0
    for r in range(1, l2 + 1):
        for c in range(1, l1 + 1):
            d = H[r - 1][c - 1] + int(sub[s2[r - 1]][s1[c - 1]])
            if algo == "nw":
                H[r][c] = max(d, H[r - 1][c] + gap, H[r][c - 1] + gap)
                continue
            X[r][c] = max(H[r][c - 1] + opn, X[r][c - 1] + ext)
            Y[r][c] = max(H[r - 1][c] + opn, Y[r - 1][c] + ext)
            H[r][c] = max(d, X[r][c], Y[r][c], 0 if algo == "sw" else NEG)
            best = max(best, H[r][c])
    return best if algo == "sw" else H[l2][l1]


@pytest.mark.parametrize("algo", dp.ALGOS)
@pytest.mark.parametrize("gaps", [(-3, -5, -1), (-1, -2, -3), (-4, -10, -1)])
def test_reference_matches_brute_force(algo, gaps):
    rng = np.random.default_rng(hash((algo, gaps)) % 2**32)
    m = rng.integers(-6, 8, (6, 6))
    sub = (m + m.T) // 2
    pairs = [(rng.integers(0, 6, rng.integers(1, 13)),
              rng.integers(0, 6, rng.integers(1, 13))) for _ in range(50)]
    got = pair_scores(algo, pairs, sub, gaps, budget=150)
    want = [brute(algo, a, b, sub, *gaps) for a, b in pairs]
    assert got.tolist() == want
    # Either way round: the reference's shorter-rows orientation is sound.
    assert [brute(algo, b, a, sub, *gaps) for a, b in pairs] == want


def test_reference_on_blosum62_at_protein_lengths():
    _, sub, lut = matrix.load(BENCH / "data" / "blosum62.txt")
    rng = np.random.default_rng(3)
    res = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    seqs = [lut[rng.choice(res, int(rng.integers(1, 40)))] for _ in range(12)]
    pairs = [(seqs[i], seqs[j]) for i in range(12) for j in range(i + 1, 12)]
    got = pair_scores("ga", pairs, sub, (0, -10, -1), budget=300)
    assert got.tolist() == [brute("ga", a, b, sub, 0, -10, -1)
                            for a, b in pairs]
    # A sequence against itself scores the sum of its diagonal entries.
    s = seqs[0]
    assert pair_scores("ga", [(s, s)], sub, (0, -10, -1))[0] == int(
        sub[s, s].sum())


def test_band_is_the_control_and_only_lowers_scores():
    _, sub, lut = matrix.load(BENCH / "data" / "blosum62.txt")
    rng = np.random.default_rng(4)
    res = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    pairs = [(lut[rng.choice(res, int(rng.integers(20, 80)))],
              lut[rng.choice(res, int(rng.integers(20, 80)))])
             for _ in range(40)]
    full = pair_scores("ga", pairs, sub, (0, -10, -1))
    banded = pair_scores("ga", pairs, sub, (0, -10, -1), band=8)
    assert (banded <= full).all() and (banded < full).any()
    wide = pair_scores("ga", pairs, sub, (0, -10, -1), band=200)
    assert wide.tolist() == full.tolist()


def test_reference_refuses_what_it_cannot_score():
    sub = np.array([[1, 0], [-1, 1]])
    with pytest.raises(ValueError, match="symmetric"):
        pair_scores("ga", [([0], [1])], sub, (0, -1, -1))
    with pytest.raises(ValueError, match="negated"):
        pair_scores("ga", [([0], [1])], np.eye(2), (0, 1, -1))
