"""The per-pair kernel's launch layout (ops/cuda_dp.pair_lanes and
pairs_layout: lanes per pair, grid and scratch, from the shapes and the card
alone) on the CPU, and the kernel's plain version against the JAX package's
NumPy oracle at the stripe-boundary lengths at which chip_smoke.py holds the
kernel's split form against that plain version on the card.
"""

import numpy as np
import pytest
import torch

from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.ops import oracle as ref_oracle
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.ops import cuda_dp, geometry, torch_dp
from sequencealigner_tpu_torch.tools.profile_main import proteins

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
#: An H100: 132 SMs; resident blocks per SM of the GA/SW per-pair kernel in
#: its one-lane and its split form (the occupancy query on the card).
SMS, RESIDENT = 132, (3, 2)
LANES = (1, 2, 4, 8, 16, 32)
PAIRS = (1, 2, 7, 64, 100, 512, 2048, 8128, 30000, 50688, 101376, 10**6)
EDGES = (1, 16, 32, 33, 64, 96, 160, 512, 1000, 3000, 12288)


def _bands(edge):
    return -(-edge // cuda_dp.KB)


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
def test_pair_lanes_is_the_smallest_power_of_two_that_fills(resident):
    """G is a power of two from 1 to 32, never more than the k edge's
    bands, and the smallest for which the pairs fill the resident grid,
    where the caps allow."""
    fill = SMS * resident * geometry.LANE
    for npairs in PAIRS:
        for edge in EDGES:
            g = cuda_dp.pair_lanes(npairs, edge, SMS, resident)
            assert g in LANES
            assert g <= _bands(edge)
            if g > 1:
                assert npairs * (g // 2) < fill
            if g < 32 and 2 * g <= _bands(edge):
                assert npairs * g >= fill


@pytest.mark.parametrize("edge", [64, 512, 3000, 12288])
def test_pair_lanes_never_grows_with_the_pair_count(edge):
    for resident in (2, 3):
        lanes = [cuda_dp.pair_lanes(n, edge, SMS, resident)
                 for n in range(1, 300001, 997)]
        assert all(a >= b for a, b in zip(lanes, lanes[1:]))


def test_long_dna_launch_splits_pairs_across_lanes():
    """The long DNA set (128 sequences of 3,000-9,000 nt: one launch of
    8,128 pairs) takes at least 8 lanes a pair, at a 9,000-row edge and at
    its bucket's edge of 12,288."""
    for edge in (9000, 12288):
        assert cuda_dp.pair_lanes(8128, edge, SMS, RESIDENT[0]) >= 8


def _launches(monkeypatch, raw, outer: str):
    """Pair counts and k edges of every align_pairs launch of a GA run
    over ``raw`` as the engine groups it, the kernels stubbed out."""
    seen = []

    def pairs(mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, *, algo,
              on_launch=None):
        seen.append((rc.shape[0], mat_k.shape[1]))
        return torch.zeros(rc.shape[0], dtype=torch.int32)

    def tiles(desc, cwords, kmatT, klens, sub, gaps, *, algo, dp16=False,
              on_launch=None):
        return torch.zeros((desc.shape[0], geometry.S_TILE, geometry.LANE),
                           dtype=torch.int32)

    monkeypatch.setattr(cuda_dp, "align_pairs", pairs)
    monkeypatch.setattr(cuda_dp, "align_tiles", tiles)
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    from sequencealigner_tpu_torch.io.input import SequenceSet

    ss = SequenceSet.from_list(raw, M.lut)
    eng = port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    eng.align_all(ss, None, progress=False)
    return seen


def test_waves_of_a_launch(monkeypatch):
    """cuda_dp.pairs_waves, which a traced run's launch counts read: a
    launch's warp items over the warps of the resident grid of the form it
    runs, the split form's for G > 1, as the scratch allows; more than one
    wave exactly where pairs_layout's grid is the whole resident grid."""
    # 256 genomes of 7,000-8,000 nt: 32,640 pairs at G 2 are 2,040 warp
    # items on 132 SMs x 2 split blocks x 4 warps.
    g = cuda_dp.pairs_layout(32640, 8064, 8064, SMS, RESIDENT)[0]
    assert g == 2
    assert cuda_dp.pairs_waves(32640, g, 8064, 8064, SMS,
                               RESIDENT) == 2040 / (SMS * 2 * 4)
    # Few pairs fill part of the card.
    assert cuda_dp.pairs_waves(64, 4, 100, 100, SMS,
                               RESIDENT) == 8 / (SMS * 2 * 4)
    # Edges whose stream would pass SCRATCH_BYTES keep one block per SM.
    assert cuda_dp.pairs_waves(10**7, 1, 2 << 20, 64, SMS,
                               RESIDENT) == 10**7 // 32 / (SMS * 4)
    for npairs in PAIRS:
        for edge in EDGES:
            g, grid, _, _ = cuda_dp.pairs_layout(npairs, edge, edge, SMS,
                                                 RESIDENT)
            waves = cuda_dp.pairs_waves(npairs, g, edge, edge, SMS,
                                        RESIDENT)
            blocks = -(-npairs * g // 32 // 4)
            assert (waves > 1) == (grid < blocks)
    assert cuda_dp.tiles_waves(33, 0, False, SMS, 1) == 33 * 128 / SMS


def test_a_cpu_launch_reports_no_waves():
    """On the CPU the wrappers' on_launch gets G 1 and no waves."""
    seen = []
    mat = torch.randint(0, 20, (4, 40), dtype=torch.int8,
                        generator=torch.Generator().manual_seed(3))
    lens = torch.tensor([40, 31, 25, 38], dtype=torch.int32)
    rows = torch.tensor([0, 1, 2], dtype=torch.int32)
    sub = torch.zeros((25, 25), dtype=torch.int32)
    gaps = torch.tensor([0, -10, -1], dtype=torch.int32)
    cuda_dp.align_pairs(mat, mat, rows, rows + 1, lens, lens, sub, gaps,
                        algo="ga", on_launch=lambda *a: seen.append(a))
    assert seen == [(1, 0.0)]


def test_main_set_lanes(monkeypatch):
    """On the main set (4096 proteins of 50-500, seed 1), most linear-v1
    pairs go through one-lane launches (those that fill the resident grid),
    and the small launches the schedule's tails leave, and most of the
    tiles-v2 diagonal remainder's, split their pairs across lanes."""
    raw = proteins(np.random.default_rng(1), 4096, 50, 500)
    fill = SMS * RESIDENT[0] * geometry.LANE
    linear = _launches(monkeypatch, raw, "0")
    slots = sum(n for n, _ in linear)  # pairs and the blocks' pad slots
    assert slots >= 4096 * 4095 // 2
    lanes = [(n, cuda_dp.pair_lanes(n, e, SMS, RESIDENT[0]))
             for n, e in linear]
    assert all((g == 1) == (n >= fill) for n, g in lanes)
    assert sum(n for n, g in lanes if g == 1) >= 0.8 * slots
    diag = _launches(monkeypatch, raw, "1")
    assert len(diag) >= 10
    assert all((cuda_dp.pair_lanes(n, e, SMS, RESIDENT[0]) > 1) == (n < fill)
               for n, e in diag)
    assert sum(n < fill for n, _ in diag) >= len(diag) - 1


def test_scratch_is_bounded_by_the_resident_grid():
    """The scratch is one stream row per resident block, whatever the pair
    count; the split form keeps one slot per group of G lanes."""
    sizes = set()
    for n in (10**5, 10**6, 10**7):
        g, grid, wmax, nint = cuda_dp.pairs_layout(n, 512, 512, SMS,
                                                   RESIDENT)
        assert (g, grid, wmax) == (1, SMS * RESIDENT[0], 512)
        sizes.add(nint)
    assert sizes == {SMS * RESIDENT[0] * 2 * 512 * geometry.LANE}
    g, grid, wmax, nint = cuda_dp.pairs_layout(8128, 12288, 12288, SMS,
                                               RESIDENT)
    assert g == 8 and grid == SMS * RESIDENT[1]
    assert nint == grid * 2 * 12288 * (geometry.LANE // 8)
    # A launch of few pairs takes one block per four warp items.
    g, grid, _, _ = cuda_dp.pairs_layout(64, 100, 100, SMS, RESIDENT)
    assert g == 4 and grid == 64 * g // 32 // 4 + (64 * g // 32 % 4 > 0)
    # Single-band launches need no stream; columns round up to a group.
    assert cuda_dp.pairs_layout(10**6, 30, 32, SMS, RESIDENT)[2:] == (0, 0)
    assert cuda_dp.pairs_layout(10**6, 30, 33, SMS, RESIDENT)[2] == 32
    # Edges whose stream would pass SCRATCH_BYTES keep one block per SM.
    g, grid, wmax, nint = cuda_dp.pairs_layout(10**7, 2 << 20, 64, SMS,
                                               RESIDENT)
    assert grid == SMS and nint * 4 > cuda_dp.SCRATCH_BYTES


BOUNDARY_L1 = (1, 3, 4, 5, 40)
BOUNDARY_L2 = (1, 31, 32, 33, 255, 256, 257, 1023, 1024, 1025)


@pytest.mark.parametrize("algo,gaps", [("nw", (-4, 0, 0)),
                                       ("ga", (0, -10, -1)),
                                       ("sw", (0, -10, -1))])
def test_plain_matches_oracle_at_stripe_boundaries(algo, gaps):
    """align_pairs_plain == the NumPy oracle on every (l1, l2) pair of the
    boundary lengths: l2 at KB = 32 and at G * KB +- 1 for G = 8 and 32,
    l1 around a group of four columns."""
    rng = np.random.default_rng(4)
    c = [rng.integers(0, 20, n).astype(np.int8) for n in BOUNDARY_L1]
    k = [rng.integers(0, 20, n).astype(np.int8) for n in BOUNDARY_L2]
    mat_c = np.full((len(c), max(BOUNDARY_L1)), geometry.PAD, np.int8)
    mat_k = np.full((len(k), max(BOUNDARY_L2)), geometry.PAD, np.int8)
    for r, s in enumerate(c):
        mat_c[r, : len(s)] = s
    for r, s in enumerate(k):
        mat_k[r, : len(s)] = s
    rc, rk = np.meshgrid(np.arange(len(c)), np.arange(len(k)),
                         indexing="ij")
    sub, g = port_engine.from_reference_inputs(M.matrix, gaps, "cpu")
    got = torch_dp.align_pairs_plain(
        torch.from_numpy(mat_c), torch.from_numpy(mat_k),
        torch.from_numpy(rc.ravel().astype(np.int32)),
        torch.from_numpy(rk.ravel().astype(np.int32)),
        torch.tensor(BOUNDARY_L1, dtype=torch.int32),
        torch.tensor(BOUNDARY_L2, dtype=torch.int32), sub, g, algo=algo,
    ).numpy()
    want = [ref_oracle.align_score(algo, c[i], k[j], M.matrix, gap=gaps[0],
                                   opn=gaps[1], ext=gaps[2])
            for i, j in zip(rc.ravel(), rk.ravel())]
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_every_lane_count_matches_plain_on_card():
    """align_pairs equals its plain version for NW/GA/SW at shapes that
    launch every G (1 to 32) on the card; run on a machine with an NVIDIA
    GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(9)
    seen = set()
    for n, edge in ((262144, 64), (8192, 64), (8192, 160), (8192, 320),
                    (2048, 512), (64, 1100)):
        lens_c = rng.integers(1, edge + 1, 300).astype(np.int32)
        lens_k = rng.integers(1, edge + 1, 300).astype(np.int32)
        lens_k[:4] = (1, 31, 33, min(edge, 1025))
        mats = []
        for lens in (lens_c, lens_k):
            mat = np.full((300, edge), geometry.PAD, np.int8)
            for r, ln in enumerate(lens):
                mat[r, :ln] = rng.integers(0, 20, ln)
            mats.append(mat)
        rc = rng.integers(0, 300, n).astype(np.int32)
        rk = rng.integers(0, 300, n).astype(np.int32)
        args = [torch.from_numpy(a).to(dev)
                for a in (*mats, rc, rk, lens_c, lens_k)]
        for algo, gaps in (("nw", (-4, 0, 0)), ("ga", (0, -10, -1)),
                           ("sw", (0, -10, -1))):
            seen.add(cuda_dp.pair_lanes(
                n, edge, sms, cuda_dp.pairs_resident(algo, False)))
            sub, g = port_engine.from_reference_inputs(M.matrix, gaps, dev)
            got = cuda_dp.align_pairs(*args, sub, g, algo=algo)
            want = torch_dp.align_pairs_plain(*args, sub, g, algo=algo)
            assert torch.equal(got, want), (algo, n, edge)
    assert seen == set(LANES)


BUILD_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112pairs_kernelILi1ELb1EEEvPKai' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112pairs_kernelILi1ELb1EEEvPKai
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 175 registers, used 1 barriers, 2500 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112pairs_kernelILi1ELb0EEEvPKai' for 'sm_90a'
ptxas info    : Used 167 registers, used 1 barriers, 2500 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112tiles_kernelILi2EEEvPKii' for 'sm_90a'
ptxas info    : Used 167 registers, used 1 barriers, 2508 bytes smem
"""


def test_register_report_reads_both_per_pair_forms(monkeypatch):
    from sequencealigner_tpu_torch.tools import profile_main

    monkeypatch.setattr(cuda_dp, "build_log", BUILD_LOG)
    assert profile_main.registers("pairs_kernel") == {
        ("ga", True): 175, ("ga", False): 167}
    assert profile_main.registers("tiles_kernel") == {"sw": 167}
    assert profile_main.registers("grid_kernel") == {}
