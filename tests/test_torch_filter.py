"""The port's similarity filter against the JAX package's, on the CPU: the
same seeded sets through both filter_sequences, kept indices and the
dropped count equal exactly."""

import numpy as np
import pytest
import torch

import sequencealigner_tpu as ref_pkg
import sequencealigner_tpu_torch as port_pkg
from sequencealigner_tpu import filter as ref_filter
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu_torch import filter as port_filter
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.scheduler import Schedule

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def _both(seqs, threshold, block=512):
    """(kept, dropped) of the port's filter on the CPU and of the JAX
    package's, on the same sequences; asserts they are equal."""
    seqs = [np.frombuffer(s.encode(), np.uint8) if isinstance(s, str)
            else np.asarray(s, np.uint8) for s in seqs]
    got, dgot = port_filter.filter_sequences(
        SequenceSet.from_list(seqs, M.lut), threshold, block=block,
        progress=False, device="cpu")
    want, dwant = ref_filter.filter_sequences(
        RefSequenceSet.from_list(seqs, M.lut), threshold, block=block,
        progress=False)
    assert dgot == dwant
    np.testing.assert_array_equal(got.kept, want.kept)
    assert [got.get_str(i) for i in range(got.num)] == [
        want.get_str(i) for i in range(want.num)]
    return list(got.kept), dgot


def _cascade_set():
    base = "AAAAAAAAAA"
    b = "AAAAAAAACC"  # 8/10 vs base: killed by base (a prior segment)
    c = "AAAAAACCCC"  # 6/10 vs base, 8/10 vs the killed b: survives
    filler = ["GGGGCCCCGG", "CCCCGGGGCC", "GCGCGCGCGC", "CGCGCGCGCG",
              "GGCCGGCCGG", "CCGGCCGGCC", "GCCGGCCGGC"]
    return [base] + filler + [b, c]


def _ac_set():
    rng = np.random.default_rng(5)
    return ["".join(rng.choice(list("AC"), rng.integers(4, 12)))
            for _ in range(40)]


# The cases of tests/test_engine.py::TestFilter: (sequences, threshold,
# block, expected kept indices, expected dropped).
TESTFILTER_CASES = {
    "exact_duplicates": (["ARND", "ARND", "CQEG"], 0.9, 512, [0, 2], 1),
    "greedy_keep_first": (["AAAAAAAAAA", "AAAAAAAACC", "AAAAAACCCC"], 0.7,
                          512, [0, 2], 1),
    "min_length_prefix": (["ARND", "ARNDWWWW", "CCCC"], 0.99, 512, [0, 2], 1),
    "threshold_at_boundary": (["AAAA", "AACC"], 0.5, 512, [0], 1),
    "threshold_above_boundary": (["AAAA", "AACC"], 0.51, 512, [0, 1], 0),
    # Segments of 32 (block 4) cross the pair space; one segment (512).
    "blocked": (_ac_set(), 0.6, 4, None, None),
    "unblocked": (_ac_set(), 0.6, 512, None, None),
    "cross_segment_cascade": (_cascade_set(), 0.75, 1,
                              [0, 1, 2, 3, 4, 5, 6, 7, 9], 1),
}


@pytest.mark.parametrize("case", sorted(TESTFILTER_CASES))
def test_filter_cases_match_reference(case):
    seqs, thr, block, kept, dropped = TESTFILTER_CASES[case]
    got = _both(seqs, thr, block)
    if kept is not None:
        assert got == (kept, dropped)


def test_no_threshold_is_a_no_op():
    ss = SequenceSet.from_list([np.frombuffer(b"ARND", np.uint8)] * 2, M.lut)
    out, dropped = port_filter.filter_sequences(ss, 0.0, progress=False,
                                                device="cpu")
    assert out is ss and dropped == 0


def _mutate(rng, s, k):
    """s with k positions substituted by a different residue."""
    s = s.copy()
    for p in rng.choice(len(s), k, replace=False):
        s[p] = rng.choice(AA[AA != s[p]])
    return s


def _random_set(seed):
    """Proteins over two or more buckets with near-copies (a few positions
    substituted) and prefix truncations of earlier sequences, some above
    and some below the thresholds tested."""
    rng = np.random.default_rng(seed)
    lens = np.r_[rng.integers(10, 17, 140), rng.integers(100, 300, 80)]
    seqs = [rng.choice(AA, int(n)) for n in rng.permutation(lens)]
    for _ in range(60):
        src = seqs[int(rng.integers(0, len(seqs)))]
        if rng.random() < 0.7:
            new = _mutate(rng, src, int(rng.integers(0, len(src) // 4 + 1)))
        else:
            new = src[: int(rng.integers(1, len(src) + 1))].copy()
        seqs.insert(int(rng.integers(0, len(seqs) + 1)), new)
    return seqs


@pytest.mark.parametrize("seed,threshold,block", [
    (1, 0.9, 512), (2, 0.8, 16), (3, 0.95, 64), (4, 0.75, 8)])
def test_random_sets_match_reference(seed, threshold, block):
    seqs = _random_set(seed)
    sched = Schedule.build(np.array([len(s) for s in seqs]))
    assert len(sched.buckets) >= 2
    kept, dropped = _both(seqs, threshold, block)
    assert 0 < dropped < len(seqs)


def test_counts_past_256_are_exact():
    """Counts past 256 that bf16 would round across the threshold, in both
    directions: 257 of 285 positions match (0.9018 >= 0.9, dropped; bf16
    reads 256, 0.8982) and 259 of 288 (0.8993, kept; bf16 reads 260,
    0.9028)."""
    rng = np.random.default_rng(7)
    a = rng.choice(AA, 285)
    b = rng.choice(AA, 288)
    filler = [rng.choice(AA, int(n)) for n in rng.integers(250, 320, 6)]
    seqs = [a, filler[0], b, filler[1], _mutate(rng, a, 285 - 257),
            filler[2], _mutate(rng, b, 288 - 259), *filler[3:]]
    rounded = torch.tensor([257.0, 259.0]).to(torch.bfloat16).float()
    assert rounded.tolist() == [256.0, 260.0]
    kept, dropped = _both(seqs, 0.9)
    assert dropped == 1 and 4 not in kept and 6 in kept


@pytest.mark.parametrize("algo,kw", [("ga", dict(open=10, extend=1)),
                                     ("nw", dict(gap=4))])
def test_library_align_filter_matches_reference(algo, kw):
    """align(filter_threshold=) returns the JAX package's (matrix, kept)."""
    rng = np.random.default_rng(11)
    seqs = [rng.choice(AA, int(n)) for n in rng.integers(10, 40, 30)]
    seqs += [_mutate(rng, s, 1) for s in seqs[:8]]
    strs = [s.tobytes().decode() for s in seqs]
    got, kept = port_pkg.align(strs, algo=algo, filter_threshold=0.9,
                               device="cpu", **kw)
    want, wkept = ref_pkg.align(strs, algo=algo, filter_threshold=0.9,
                                device="cpu", **kw)
    np.testing.assert_array_equal(kept, wkept)
    np.testing.assert_array_equal(got, want)
    assert len(kept) == 30
