"""The port's DP kernels (plain PyTorch versions on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Every comparison is exact int32 equality over the whole output, dummy rows
and pad lanes included.  The CUDA kernels themselves are compared with the
same plain versions on the card (chip_smoke.py, and the ``cuda``-marked test
here).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.ops import oracle as ref_oracle
from sequencealigner_tpu.ops import pallas_dp
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.ops import cuda_dp, geometry, torch_dp

M = ref_matrices.get("blosum62")
SUB_T, _ = port_engine.from_reference_inputs(M.matrix, (0, 0, 0), "cpu")
SUB_J = jnp.asarray(SUB_T.numpy())
PAD = geometry.PAD

GAP_CASES = [
    ("nw", (-4, 0, 0)),
    ("ga", (0, -10, -1)),
    ("sw", (0, -8, -2)),
    # extend worse than open: GA's border slope max(opn, ext) and the
    # y-scan slope; SW's zero floor with no gap reopen.
    ("ga", (0, -1, -5)),
    ("sw", (0, -2, -7)),
]


def _bucket(rng, count, edge):
    """(count, edge) int8 codes, PAD beyond random true lengths that
    include 1 and the edge."""
    lens = rng.integers(1, edge + 1, count).astype(np.int32)
    lens[0], lens[-1] = 1, edge
    mat = np.full((count, edge), PAD, np.int8)
    for i, ln in enumerate(lens):
        mat[i, :ln] = rng.integers(0, 20, ln)
    return mat, lens


def _gaps(gaps):
    return torch.tensor(gaps, dtype=torch.int32), jnp.asarray(
        np.array(gaps, np.int32)
    )


# (algo, gaps, Lc, Lk, c count, k count, with a dummy descriptor row): each
# case is one interpret-mode kernel run, so the list stays short.
TILE_CASES = [
    (*GAP_CASES[0], 64, 32, 21, 9, True),
    (*GAP_CASES[1], 96, 96, 9, 7, False),
    (*GAP_CASES[2], 96, 96, 9, 7, True),
    (*GAP_CASES[3], 64, 32, 21, 9, False),
    (*GAP_CASES[4], 96, 96, 9, 7, False),
]


@pytest.mark.parametrize("algo,gaps,Lc,Lk,cc,kc,dummy", TILE_CASES)
def test_tiles_plain_matches_align_outer(algo, gaps, Lc, Lk, cc, kc, dummy):
    """align_tiles_plain == pallas_dp.align_outer on every output slot,
    dummy all-pad descriptor rows included (cf. tests/test_pallas.py
    outer-tile cases; Lk = 96 is a multi-band geometry)."""
    rng = np.random.default_rng(zlib.crc32(f"{algo}{gaps}{Lc}".encode()))
    cmat, clens = _bucket(rng, cc, Lc)
    kmat, klens = _bucket(rng, kc, Lk)
    cw = geometry.pack_bucket_outer(cmat, clens, Lc)
    kw = geometry.pack_bucket_outer(kmat, klens, Lk)
    desc = np.array(
        [(0, 0)] + [(cw[0].shape[0] - geometry.S_TILE, 0)] * dummy, np.int32
    )
    gt, gj = _gaps(gaps)
    got = torch_dp.align_tiles_plain(
        torch.from_numpy(desc), torch.from_numpy(cw[0]),
        torch.from_numpy(kw[1]), torch.from_numpy(kw[2]), SUB_T, gt,
        algo=algo,
    ).numpy()
    want = np.asarray(pallas_dp.align_outer(
        jnp.asarray(desc), jnp.asarray(cw[0]), jnp.asarray(kw[1]),
        jnp.asarray(kw[2]), SUB_J, gj, algo=algo, Lc=Lc, Lk=Lk,
        interpret=True,
    ))
    np.testing.assert_array_equal(got, want)
    assert not got[1:].any()  # a dummy tile scores zeros


PAIR_CASES = [
    (*GAP_CASES[0], 80, 70),
    (*GAP_CASES[1], 320, 32),  # the cross-band packed-words combo
    (*GAP_CASES[2], 21, 13),
    (*GAP_CASES[3], 80, 70),
    (*GAP_CASES[4], 80, 70),
]


@pytest.mark.parametrize("algo,gaps,Lc,Lk", PAIR_CASES)
def test_pairs_plain_matches_align_packed(algo, gaps, Lc, Lk):
    """align_pairs_plain on bucket code matrices == pallas_dp.align_packed
    on the same pairs' pack_bucket_words rows (cf. tests/test_pallas.py
    inline-scoring and cross-band cases)."""
    rng = np.random.default_rng(zlib.crc32(f"{algo}{gaps}{Lk}".encode()))
    cmat, clens = _bucket(rng, 40, Lc)
    kmat, klens = _bucket(rng, 30, Lk)
    n = pallas_dp.LANE
    rc = rng.integers(0, 40, n).astype(np.int32)
    rk = rng.integers(0, 30, n).astype(np.int32)
    rc[:2], rk[:2] = (0, 39), (29, 0)  # length-1 and edge-length pairs
    gt, gj = _gaps(gaps)
    got = torch_dp.align_pairs_plain(
        torch.from_numpy(cmat), torch.from_numpy(kmat), torch.from_numpy(rc),
        torch.from_numpy(rk), torch.from_numpy(clens),
        torch.from_numpy(klens), SUB_T, gt, algo=algo,
    ).numpy()
    cform, _ = pallas_dp.pack_bucket_words(cmat, Lc)
    _, kform = pallas_dp.pack_bucket_words(kmat, Lk)
    want = np.asarray(pallas_dp.align_packed(
        jnp.asarray(cform[rc]), jnp.asarray(kform[rk]),
        jnp.asarray(clens[rc]), jnp.asarray(klens[rk]), SUB_J, gj,
        algo=algo, Lc=Lc, Lk=Lk, B=n, interpret=True,
    ))
    np.testing.assert_array_equal(got, want)


def test_sw_zero_cell_no_gap_reopen():
    """SW pairs whose best local alignment starts right after a cell
    clamped to zero, with open >> extend (cf. tests/test_pallas.py:363)."""
    rng = np.random.default_rng(11)
    n = L = 16
    mat_c = np.full((n, L), PAD, np.int8)
    mat_k = np.full((n, L), PAD, np.int8)
    lc = np.zeros(n, np.int32)
    lk = np.zeros(n, np.int32)
    for b in range(n):
        pre, run, gl = (int(rng.integers(1, 5)), int(rng.integers(2, 6)),
                        int(rng.integers(1, 4)))
        a = list(rng.integers(0, 20, pre)) + [17] * run
        c = list(rng.integers(0, 20, pre)) + [0] * gl + [17] * run
        lc[b], lk[b] = min(len(a), L), min(len(c), L)
        mat_c[b, : lc[b]] = a[: lc[b]]
        mat_k[b, : lk[b]] = c[: lk[b]]
    idx = torch.arange(n, dtype=torch.int32)
    got = torch_dp.align_pairs_plain(
        torch.from_numpy(mat_c), torch.from_numpy(mat_k), idx, idx,
        torch.from_numpy(lc), torch.from_numpy(lk), SUB_T,
        torch.tensor([0, -12, -1], dtype=torch.int32), algo="sw",
    ).numpy()
    want = [
        ref_oracle.sw_affine(mat_c[b, : lc[b]], mat_k[b, : lk[b]], M.matrix,
                             -12, -1)
        for b in range(n)
    ]
    np.testing.assert_array_equal(got, want)


def test_zero_length_pairs_score_zero():
    mat, lens = _bucket(np.random.default_rng(0), 4, 40)
    lens[2] = 0
    idx = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    for algo, gaps in GAP_CASES[:3]:
        got = torch_dp.align_pairs_plain(
            torch.from_numpy(mat), torch.from_numpy(mat), idx, idx.flip(0),
            torch.from_numpy(lens), torch.from_numpy(lens), SUB_T,
            torch.tensor(gaps, dtype=torch.int32), algo=algo,
        )
        assert got[0] == 0 and got[3] == 0


@pytest.mark.parametrize("count", [130, 256, 300])
def test_diag_rows_match_reference(count):
    """The diagonal-remainder pair-row inversion (tail-window slots clamped
    to the bucket) equals the reference's on-device _pair_rows."""
    nwin = -(-count // geometry.LANE)
    n_slots = nwin * (geometry.LANE * (geometry.LANE - 1) // 2)
    width = 1 << (n_slots - 1).bit_length()  # covers pad slots past n_slots
    rc, rk = port_engine._diag_rows(
        torch.arange(width, dtype=torch.int64), n_slots, count
    )
    jrc, jrk = ref_engine._pair_rows(
        jnp.zeros(count, jnp.int32), 0, n_slots, Wloc=width, mode="diag",
        small=True,
    )
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))


@pytest.mark.parametrize(
    "gaps", [(-4, 0, 0), (0, -10, -1), (0, -200, -1), (0, -1, -300)]
)
def test_int16_bound_matches_reference(gaps):
    ref = ref_engine.Engine("ga", M.matrix, gaps, device_kind="cpu")
    port = port_engine.Engine("ga", M.matrix, gaps, device="cpu")
    for Lc, Lk in [(64, 32), (128, 128), (256, 24), (4096, 4096)]:
        assert port._int16_ok(Lc, Lk) == ref._int16_ok(Lc, Lk), (Lc, Lk)


def test_wrappers_route_cpu_tensors_to_plain():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; a tensor on any other non-CUDA device is refused."""
    rng = np.random.default_rng(4)
    mat, lens = _bucket(rng, 8, 50)
    cw, kT, kl = (torch.from_numpy(a)
                  for a in geometry.pack_bucket_outer(mat, lens, 50))
    desc = torch.zeros((1, 2), dtype=torch.int32)
    gaps = torch.tensor([0, -10, -1], dtype=torch.int32)
    n0 = cuda_dp.align_tiles.launches
    got = cuda_dp.align_tiles(desc, cw, kT, kl, SUB_T, gaps, algo="ga")
    want = torch_dp.align_tiles_plain(desc, cw, kT, kl, SUB_T, gaps,
                                      algo="ga")
    assert torch.equal(got, want) and cuda_dp.align_tiles.launches == n0
    with pytest.raises(ValueError):
        cuda_dp.align_tiles(desc.to("meta"), cw, kT, kl, SUB_T, gaps,
                            algo="ga")
    with pytest.raises(ValueError):
        cuda_dp.align_pairs(
            torch.from_numpy(mat), torch.from_numpy(mat),
            desc[0].to("meta"), desc[0], torch.from_numpy(lens),
            torch.from_numpy(lens), SUB_T, gaps, algo="ga",
        )


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both CUDA kernels equal their plain versions on the card (multi-band
    shapes, dummy descriptor rows); run on a machine with an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cmat, clens = _bucket(rng, 200, 160)
    kmat, klens = _bucket(rng, 150, 96)
    cw = geometry.pack_bucket_outer(cmat, clens, 160)[0]
    _, kT, kl = geometry.pack_bucket_outer(kmat, klens, 96)
    desc = np.array([(0, 0), (128, 1), (cw.shape[0] - 128, 0)], np.int32)
    rc = rng.integers(0, 200, 1000).astype(np.int32)
    rk = rng.integers(0, 150, 1000).astype(np.int32)
    for algo, gaps in GAP_CASES:
        sub, g = port_engine.from_reference_inputs(M.matrix, gaps, dev)
        args = [torch.from_numpy(a).to(dev) for a in (desc, cw, kT, kl)]
        got = cuda_dp.align_tiles(*args, sub, g, algo=algo)
        want = torch_dp.align_tiles_plain(*args, sub, g, algo=algo)
        assert torch.equal(got, want), algo
        args = [torch.from_numpy(a).to(dev)
                for a in (cmat, kmat, rc, rk, clens, klens)]
        got = cuda_dp.align_pairs(*args, sub, g, algo=algo)
        want = torch_dp.align_pairs_plain(*args, sub, g, algo=algo)
        assert torch.equal(got, want), algo
