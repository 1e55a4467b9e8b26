"""The port's superblock entry points (ops/superblock.py) and the grid
kernel's plain version against the JAX package's build_stream and
align_superblock (Pallas interpreter) and the NumPy oracle, on the CPU.

Every comparison is exact int32 (or int8) equality.  The CUDA grid kernel
itself is compared with the same plain version on the card (chip_smoke.py,
tools/fuzz_hw and the ``cuda``-marked test here).
"""

import zlib

import numpy as np
import pytest
import torch

from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.ops import oracle as ref_oracle
from sequencealigner_tpu.ops import pallas_dp
from sequencealigner_tpu.ops.xla_dp import padded_submatrix
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.ops import cuda_dp, geometry, superblock, torch_dp

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
PAD = geometry.PAD
B = geometry.LANE

# tests/test_pallas.py GAP_CASES.
GAP_CASES = [
    ("nw", (-4, 0, 0)),
    ("ga", (0, -10, -1)),
    ("sw", (0, -8, -2)),
    ("ga", (0, -1, -5)),
    ("sw", (0, -2, -7)),
    ("ga", (0, -3, -3)),
]


def _block(rng, n, Lc, Lk, nlet=20):
    """n pairs of int32 codes, PAD beyond random lengths (as
    tests/test_pallas.py random_block)."""
    l1 = rng.integers(1, Lc + 1, n).astype(np.int32)
    l2 = rng.integers(1, Lk + 1, n).astype(np.int32)
    s1 = np.full((n, Lc), PAD, np.int32)
    s2 = np.full((n, Lk), PAD, np.int32)
    for b in range(n):
        s1[b, : l1[b]] = rng.integers(0, nlet, l1[b])
        s2[b, : l2[b]] = rng.integers(0, nlet, l2[b])
    return s1, s2, l1, l2


def _port_sub(matrix):
    sub, _ = port_engine.from_reference_inputs(matrix, (0, 0, 0), "cpu")
    return sub


def _port(s1, s2, l1, l2, matrix, gaps, **kw):
    t = torch.from_numpy
    return superblock.align_superblock(
        t(s1), t(s2), t(l1), t(l2), _port_sub(matrix),
        torch.tensor(gaps, dtype=torch.int32), B=B, **kw,
    ).numpy()


@pytest.mark.parametrize("S", [1, 2])
def test_build_stream_matches_reference(S):
    """The int8 (S, W, Kpad, B) grid equals the JAX build_stream's, PAD_MARK
    at every pad row and column included."""
    rng = np.random.default_rng(S)
    Lc, Lk = 40, 37
    nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
    s1, s2, l1, l2 = _block(rng, S * B, Lc, Lk)
    got = superblock.build_stream(
        torch.from_numpy(s1), torch.from_numpy(s2), _port_sub(M.matrix),
        S=S, B=B, Lc=Lc, Lk=Lk, Kpad=Kpad, W=W,
    )
    want = np.asarray(pallas_dp.build_stream(
        s1, s2, padded_submatrix(M.matrix), S=S, B=B, Lc=Lc, Lk=Lk,
        Kpad=Kpad, W=W,
    ))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == geometry.PAD_MARK).any()


SUPERBLOCK_CASES = [(*c, 80, 70) for c in GAP_CASES] + [
    (*GAP_CASES[0], 21, 13), (*GAP_CASES[4], 21, 13),
]


@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("algo,gaps,Lc,Lk", SUPERBLOCK_CASES)
def test_superblock_matches_reference(algo, gaps, Lc, Lk, inline):
    """align_superblock in both modes == the JAX align_superblock in the
    same mode (Pallas interpreter), on all 128 pairs; (80, 70) is three
    row bands, the last partly padded."""
    rng = np.random.default_rng(zlib.crc32(f"{algo}{gaps}{Lc}".encode()))
    s1, s2, l1, l2 = _block(rng, B, Lc, Lk)
    got = _port(s1, s2, l1, l2, M.matrix, gaps, algo=algo, Lc=Lc, Lk=Lk,
                inline=inline)
    want = np.asarray(pallas_dp.align_superblock(
        s1, s2, l1, l2, padded_submatrix(M.matrix), np.array(gaps, np.int32),
        algo=algo, Lc=Lc, Lk=Lk, B=B, interpret=True, inline=inline,
    ))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inline", [False, True])
def test_superblock_randomized_shapes_match_oracle(inline):
    """The randomized shape/matrix/gap fuzz of tests/test_pallas.py
    (fixed seed 99, four draws), every pair against the oracle, with
    S = 3 superblock rows."""
    rng = np.random.default_rng(99)
    for _ in range(4):
        mname = ["blosum62", "pam250", "nuc44"][rng.integers(0, 3)]
        Mx = ref_matrices.get(mname)
        nlet = 16 if mname == "nuc44" else 20
        algo = ["nw", "ga", "sw"][rng.integers(0, 3)]
        if algo == "nw":
            gaps = (-int(rng.integers(1, 13)), 0, 0)
        else:
            gaps = (0, -int(rng.integers(1, 15)), -int(rng.integers(1, 15)))
        Lc = int(rng.integers(2, 120))
        Lk = int(rng.integers(1, Lc + 1))
        s1, s2, l1, l2 = _block(rng, 3 * B, Lc, Lk, nlet)
        got = _port(s1, s2, l1, l2, Mx.matrix, gaps, algo=algo, Lc=Lc,
                    Lk=Lk, inline=inline)
        want = [
            ref_oracle.align_score(algo, s1[b, : l1[b]], s2[b, : l2[b]],
                                   Mx.matrix, gap=gaps[0], opn=gaps[1],
                                   ext=gaps[2])
            for b in range(0, 3 * B, 5)
        ]
        np.testing.assert_array_equal(got[::5], want, err_msg=str(
            (algo, mname, gaps, Lc, Lk)))


@pytest.mark.parametrize("algo,gaps", GAP_CASES[:5])
def test_grid_plain_matches_pairs_plain(algo, gaps):
    """Both plain versions on the same pairs: the grid built from the codes
    gives exactly the per-pair scores (a row count that is not a band
    multiple, zero-length pairs, pairs of full length)."""
    rng = np.random.default_rng(zlib.crc32(f"g{algo}{gaps}".encode()))
    Lc, Lk, S = 50, 45, 2
    s1, s2, l1, l2 = _block(rng, S * B, Lc, Lk)
    l1[:2], l2[:2] = (Lc, 0), (Lk, 5)
    t = torch.from_numpy
    sub = _port_sub(M.matrix)
    g = torch.tensor(gaps, dtype=torch.int32)
    nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
    sk = superblock.build_stream(t(s1), t(s2), sub, S=S, B=B, Lc=Lc, Lk=Lk,
                                 Kpad=Kpad, W=W)
    got = torch_dp.align_grid_plain(sk, t(l1), t(l2), g, algo=algo)
    rows = torch.arange(S * B, dtype=torch.int32)
    want = torch_dp.align_pairs_plain(
        t(s1.astype(np.int8)), t(s2.astype(np.int8)), rows, rows, t(l1),
        t(l2), sub, g, algo=algo,
    )
    assert torch.equal(got, want)
    assert got[1] == 0


def test_align_grid_routes_cpu_tensors_to_plain():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; tensors on another device and malformed inputs are refused."""
    rng = np.random.default_rng(4)
    s1, s2, l1, l2 = _block(rng, B, 30, 20)
    nb, Kpad, CD, W = geometry.geometry(30, 20, B)
    sub = _port_sub(M.matrix)
    g = torch.tensor([0, -10, -1], dtype=torch.int32)
    sk = superblock.build_stream(torch.from_numpy(s1), torch.from_numpy(s2),
                                 sub, S=1, B=B, Lc=30, Lk=20, Kpad=Kpad, W=W)
    l1t, l2t = torch.from_numpy(l1), torch.from_numpy(l2)
    n0 = cuda_dp.align_grid.launches
    got = cuda_dp.align_grid(sk, l1t, l2t, g, algo="ga")
    assert torch.equal(got, torch_dp.align_grid_plain(sk, l1t, l2t, g,
                                                      algo="ga"))
    assert cuda_dp.align_grid.launches == n0
    with pytest.raises(ValueError):
        cuda_dp.align_grid(sk.to("meta"), l1t, l2t, g, algo="ga")
    with pytest.raises(ValueError):
        superblock.align_superblock(
            torch.from_numpy(s1[:100]), torch.from_numpy(s2[:100]),
            l1t[:100], l2t[:100], sub, g, algo="ga", Lc=30, Lk=20, B=B,
        )


def _edge_lengths(rng, n, L, edge):
    """n lengths in 1..edge: first every one of 1, 31, 32, 33 (KB and one
    either side), L and edge, then random ones up to L."""
    fixed = [x for x in (1, 31, 32, 33, L, edge) if x <= edge]
    out = rng.integers(1, L + 1, n).astype(np.int32)
    return fixed, out


#: (Lc, Lk, S, B) of the card test: B = 128 (bulk copies), 256 (two
#: chunks) and 48 (cp.async of 16 bytes), 100 and 200 (of 4 and 8 bytes),
#: 130 (byte loads); one band, several bands, and Kpad = 64 rows.
CARD_GRIDS = [(21, 13, 1, B), (80, 70, 3, B), (50, 45, 2, 100),
              (70, 100, 2, 256), (40, 66, 1, 48), (33, 40, 1, 200),
              (30, 35, 1, 130)]


@pytest.mark.cuda
def test_grid_kernel_matches_plain_on_card():
    """The grid kernel equals its plain version on the card in every copy
    form (CARD_GRIDS), single and multi-band, at lengths 1, 31, 32, 33 and
    at the grid's edges W and Kpad (whose PAD_MARK cells then count), for
    NW, GA and SW; both superblock modes equal it at lengths within the
    codes; run on a machine with an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    forms = set()
    for Lc, Lk, S, nb_ in CARD_GRIDS:
        n = S * nb_
        s1, s2, l1, l2 = _block(rng, n, Lc, Lk)
        nb, Kpad, CD, W = geometry.geometry(Lc, Lk, nb_)
        f1, e1 = _edge_lengths(rng, n, Lc, W)
        f2, e2 = _edge_lengths(rng, n, Lk, Kpad)
        grid_pairs = [(a, b) for a in f1 for b in f2]
        assert len(grid_pairs) <= n
        e1[: len(grid_pairs)] = [a for a, _ in grid_pairs]
        e2[: len(grid_pairs)] = [b for _, b in grid_pairs]
        s1, s2, l1, l2, e1, e2 = (torch.from_numpy(a).to(dev)
                                  for a in (s1, s2, l1, l2, e1, e2))
        forms.add(cuda_dp.grid_form(nb_, 256)[0])
        for algo, gaps in GAP_CASES:
            sub, g = port_engine.from_reference_inputs(M.matrix, gaps, dev)
            sk = superblock.build_stream(s1, s2, sub, S=S, B=nb_, Lc=Lc,
                                         Lk=Lk, Kpad=Kpad, W=W)
            for a, b in ((l1, l2), (e1, e2)):
                want = torch_dp.align_grid_plain(sk, a, b, g, algo=algo)
                got = cuda_dp.align_grid(sk, a, b, g, algo=algo)
                assert torch.equal(got, want), (algo, Lc, Lk, nb_)
            want = torch_dp.align_grid_plain(sk, l1, l2, g, algo=algo)
            for inline in (False, True):
                got = superblock.align_superblock(
                    s1, s2, l1, l2, sub, g, algo=algo, Lc=Lc, Lk=Lk, B=nb_,
                    inline=inline,
                )
                assert torch.equal(got, want), (algo, Lc, Lk, nb_, inline)
    assert forms == set(cuda_dp.GRID_FORMS)
