"""The grid kernel's launch layout (ops/cuda_dp.grid_form, grid_layout:
copy form, ring stages, shared memory and grid, from the shapes and the
card alone), the bytes it copies and those its bound counts
(tools/profile_kernels.grid_traffic, grid_bound), and the kernel's plain version against
the JAX package's NumPy oracle at the lengths and lane counts at which the
card test holds the kernel's every form against that plain version.
"""

import numpy as np
import pytest
import torch

from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.ops import oracle as ref_oracle
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.ops import cuda_dp, geometry, superblock, torch_dp
from sequencealigner_tpu_torch.tools.profile_kernels import (
    grid_bound, grid_traffic)

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
#: An H100: 132 SMs.
SMS = 132


@pytest.mark.parametrize("B,form,unit", [
    (128, "bulk", 16), (256, "async", 16), (48, "async", 16),
    (100, "async", 4), (200, "async", 8), (130, "bytes", 1),
    (384, "async", 16), (1, "bytes", 1), (20, "async", 4),
])
def test_grid_form_from_the_lane_count(B, form, unit):
    """B = 128 copies a column's rows in one bulk copy; other multiples of
    16, 8 or 4 take cp.async of that many bytes; the rest byte loads.  A
    256-byte aligned grid (as the caching allocator gives) does not change
    that."""
    assert cuda_dp.grid_form(B, 256) == (form, unit)
    assert form in cuda_dp.GRID_FORMS


@pytest.mark.parametrize("align,form,unit", [
    (16, "bulk", 16), (8, "async", 8), (4, "async", 4), (2, "bytes", 1),
    (1, "bytes", 1),
])
def test_grid_form_follows_the_base_alignment(align, form, unit):
    """A grid that starts off a 16-byte boundary (a view into a larger
    tensor) takes the widest copy its start allows."""
    assert cuda_dp.grid_form(128, align) == (form, unit)


def test_stage_bytes_and_shared_memory():
    """A stage is four columns of one 32-row band of 128 lanes, 16 KB; the
    ring of four is 64 KB beside its eight 8-byte barriers, which fits two
    blocks per SM in the H100's 227 KB (three with the 1 KB the runtime
    keeps per block)."""
    assert cuda_dp.GRID_STAGES == 4
    assert cuda_dp.STAGE_BYTES == 4 * 32 * 128 == 16384
    assert cuda_dp.GRID_SMEM == 64 + 4 * 16384
    assert 3 * (cuda_dp.GRID_SMEM + 1024) <= 233472


@pytest.mark.parametrize("S,B,resident,grid", [
    (256, 128, 2, 256),   # chip_smoke.py (e) at full size: one item a block
    (256, 128, 1, 132),   # one block per SM: a block takes two items
    (1024, 128, 3, 396),  # more items than slots: SMs x resident
    (256, 256, 2, 264),   # two chunks a row: 512 items
    (3, 100, 2, 3),       # one item per superblock row
    (1, 300, 2, 3),       # three chunks, the last of 44 lanes
])
def test_grid_is_persistent_and_sized_by_residency(S, B, resident, grid):
    lay = cuda_dp.grid_layout(S, 256, 256, B, 256, SMS, resident)
    assert lay["grid"] == grid
    assert lay["stages"] == cuda_dp.GRID_STAGES
    assert lay["smem"] == cuda_dp.GRID_SMEM
    # One band-crossing row of two int32 streams per block, 128 slots.
    assert lay["wmax"] == 256 and lay["scratch"] == grid * 2 * 256 * 128


def test_single_band_grid_needs_no_scratch():
    lay = cuda_dp.grid_layout(4, 21, 32, 128, 256, SMS, 2)
    assert (lay["grid"], lay["wmax"], lay["scratch"]) == (4, 0, 0)
    lay = cuda_dp.grid_layout(4, 22, 64, 128, 256, SMS, 2)
    assert lay["wmax"] == 24  # a whole group of four columns


@pytest.mark.parametrize("l1,l2,W,Kpad,cols", [
    # Below both edges: columns up to the longest l1 of the pairs with rows
    # in each band (whole groups of four, at most the block's longest l1),
    # bands up to the longest l2 of the pairs with columns.
    ([10, 50, 0, 70], [40, 5, 90, 0], 80, 96, [50, 12]),
    ([1], [1], 80, 96, [1]),
    ([31, 32, 33], [31, 32, 33], 80, 96, [33, 33]),
    # At the edges, and past them (clamped to the grid as the kernel does).
    ([80], [96], 80, 96, [80, 80, 80]),
    ([500], [500], 80, 96, [80, 80, 80]),
    # A last band shorter than KB: Kpad = 40.
    ([8], [40], 8, 40, [8, 8]),
    # No pair with both lengths: nothing is copied.
    ([0, 5], [7, 0], 80, 96, []),
])
def test_grid_copies_a_block_up_to_its_lengths(l1, l2, W, Kpad, cols):
    """The bytes the kernel copies for one block (one 128-lane item):
    ``cols[k]`` columns of band k, each of min(32, Kpad - 32k) rows."""
    a = np.zeros(128, np.int64)
    b = np.zeros(128, np.int64)
    a[: len(l1)], b[: len(l2)] = l1, l2
    want = sum(c * min(32, Kpad - 32 * k) * 128 for k, c in enumerate(cols))
    assert grid_traffic(a, b, 1, W, Kpad, 128)["copied"] == want


def test_grid_traffic_counts_what_the_lengths_need():
    """Full lengths need and copy the whole grid; a block of short pairs
    needs only their rectangles (in 32-lane groups) and the kernel copies
    its stages up to the block's longest lengths."""
    S, W, Kpad, B = 2, 64, 64, 128
    full = grid_traffic(np.full(S * B, W), np.full(S * B, Kpad), S, W,
                        Kpad, B)
    assert full == {"grid": S * W * Kpad * B, "needed": S * W * Kpad * B,
                    "copied": S * W * Kpad * B}
    l1 = np.zeros(S * B, np.int64)
    l2 = np.zeros(S * B, np.int64)
    l1[0], l2[0] = 10, 40   # group 0 of row 0
    l1[1], l2[1] = 30, 5    # the same group: union 10 x 40 + 20 x 5
    l1[200], l2[200] = 64, 1
    t = grid_traffic(l1, l2, S, W, Kpad, B)
    assert t["needed"] == (10 * 40 + 20 * 5 + 64 * 1) * 32
    # Row 0: band 0 reaches 30 columns (groups up to 32), band 1 only the
    # first pair's 10 (three groups: 12 columns); row 1: band 0, 64.
    assert t["copied"] == (30 * 32 + 12 * 32 + 64 * 32) * 128
    assert t["needed"] <= t["copied"] <= t["grid"]


def test_grid_traffic_of_random_lengths_lies_between():
    rng = np.random.default_rng(3)
    S, W, Kpad, B = 3, 96, 96, 100
    l1 = rng.integers(0, W + 1, S * B)
    l2 = rng.integers(0, Kpad + 1, S * B)
    t = grid_traffic(l1, l2, S, W, Kpad, B)
    assert 0 < t["needed"] <= t["copied"] <= t["grid"]


def _edge_pairs(rng, n, Lc, Lk, W, Kpad):
    """n pairs of codes (PAD beyond Lc / Lk) whose first lengths are every
    pair of 1, 31, 32, 33, Lc, W x 1, 31, 32, 33, Lk, Kpad."""
    f1 = [x for x in (1, 31, 32, 33, Lc, W) if x <= W]
    f2 = [x for x in (1, 31, 32, 33, Lk, Kpad) if x <= Kpad]
    l1 = rng.integers(1, Lc + 1, n).astype(np.int32)
    l2 = rng.integers(1, Lk + 1, n).astype(np.int32)
    pairs = [(a, b) for a in f1 for b in f2]
    l1[: len(pairs)] = [a for a, _ in pairs]
    l2[: len(pairs)] = [b for _, b in pairs]
    s1 = np.full((n, Lc), geometry.PAD, np.int8)
    s2 = np.full((n, Lk), geometry.PAD, np.int8)
    for k in range(n):
        s1[k, : min(l1[k], Lc)] = rng.integers(0, 20, min(l1[k], Lc))
        s2[k, : min(l2[k], Lk)] = rng.integers(0, 20, min(l2[k], Lk))
    return s1, s2, l1, l2


@pytest.mark.parametrize("algo,gaps", [
    ("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -8, -2)),
])
@pytest.mark.parametrize("Lc,Lk,B", [(70, 100, 256), (50, 45, 100)])
def test_grid_plain_matches_oracle_at_edges(algo, gaps, Lc, Lk, B):
    """The plain version, which the card test holds every form of the
    kernel to, equals the NumPy oracle at the band and group edges and at
    the grid's edges W and Kpad, where cells past the codes score the grid's
    PAD_MARK: the oracle scores them through a matrix whose pad row and
    column hold -128."""
    rng = np.random.default_rng(len(algo) * 1000 + B)
    nb, Kpad, CD, W = geometry.geometry(Lc, Lk, B)
    s1, s2, l1, l2 = _edge_pairs(rng, B, Lc, Lk, W, Kpad)
    sub, g = port_engine.from_reference_inputs(M.matrix, gaps, "cpu")
    sk = superblock.build_stream(torch.from_numpy(s1), torch.from_numpy(s2),
                                 sub, S=1, B=B, Lc=Lc, Lk=Lk, Kpad=Kpad,
                                 W=W)
    got = torch_dp.align_grid_plain(sk, torch.from_numpy(l1),
                                    torch.from_numpy(l2), g, algo=algo)
    marked = np.full((25, 25), geometry.PAD_MARK, np.int64)
    marked[:24, :24] = M.matrix
    c1 = np.full((B, W), geometry.PAD, np.int64)
    c1[:, :Lc] = s1
    c2 = np.full((B, Kpad), geometry.PAD, np.int64)
    c2[:, :Lk] = s2
    for k in range(0, B, 3):
        want = ref_oracle.align_score(algo, c1[k, : l1[k]], c2[k, : l2[k]],
                                      marked, gap=gaps[0], opn=gaps[1],
                                      ext=gaps[2])
        assert got[k] == want, (k, l1[k], l2[k])


@pytest.mark.parametrize("short", [False, True])
def test_grid_bound_counts_the_bytes_the_lengths_need(short):
    """The grid kernel's bound is the sectors its pairs' lengths reach (plus
    lengths, gaps and scores) at 3.35 TB/s, not the whole grid: at full
    lengths the two agree, and short pairs lower it.  A needed cell is a
    byte, which takes longer to read than GA's instructions for it take to
    issue, so bytes bound the call."""
    S, W, Kpad, B = 4, 256, 256, 128
    l1 = np.full(S * B, W)
    l2 = np.full(S * B, Kpad)
    if short:
        l1[::2], l2[1::2] = 10, 20
    ms, by, traffic = grid_bound(l1, l2, S, W, Kpad, B, "ga")
    assert by == "bytes"
    small = 3 * 4 * S * B + 12
    assert ms == pytest.approx((traffic["needed"] + small) / 3.35e9)
    if short:
        assert traffic["needed"] < traffic["grid"]
    else:
        assert traffic["needed"] == traffic["grid"] == S * W * Kpad * B



@pytest.mark.parametrize("argv", [[], ["ga,256,256,128,256,random,check"]])
def test_profile_kernels_exits_2_without_a_card(argv, capsys):
    from sequencealigner_tpu_torch.tools import profile_kernels

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profile_kernels.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
