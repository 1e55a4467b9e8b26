"""The port's engine over a list of device entries (the reference's
multi-device mesh), on the CPU: ``device=["cpu"] * k`` runs the dispatch,
per-entry arrays and assignment of the multi-device path.  Matrices must
equal the one-entry run and the JAX engine's, bit for bit; block ids and
schedule tokens must not depend on the entry count."""

import functools

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu_torch import checkpoint as ckpt
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch import entry
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.ops import cuda_dp, geometry
from sequencealigner_tpu_torch.scheduler import Schedule

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -9, -2))]
GAPS = (0, -10, -1)
SENTINEL = -777


def _two_bucket_seqs():
    """The 210-sequence two-bucket set of tests/test_torch_engine.py."""
    rng = np.random.default_rng(21)
    return [rng.choice(AA, int(n))
            for n in np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]]


def _run(devices, algo="ga", gaps=GAPS, seqs=None, **kw):
    ss = SequenceSet.from_list(seqs or _two_bucket_seqs(), M.lut)
    eng = port_engine.Engine(algo, M.matrix, gaps, device=devices)
    store = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, store, progress=False, **kw)
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    return np.asarray(store.matrix).reshape(ss.num, ss.num), stats


@functools.lru_cache(maxsize=None)
def _one_entry(algo, gaps, outer):
    """The one-entry matrix (cached per schedule; the caller sets
    SEQALIGN_TPU_OUTER to ``outer``)."""
    return _run("cpu", algo, gaps)[0]


@pytest.mark.parametrize("outer", ["1", "0"])
@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
@pytest.mark.parametrize("k", [2, 3])
def test_entries_give_the_one_entry_matrix(monkeypatch, k, algo, gaps, outer):
    """k CPU entries give the one-entry matrix for NW, GA and SW, under
    tiles-v2 and linear-v1, and split the cells sent among them."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    got, stats = _run(["cpu"] * k, algo, gaps)
    np.testing.assert_array_equal(got, _one_entry(algo, gaps, outer))
    assert len(stats.lane_launches) == k
    assert sum(stats.lane_cells) == stats.cells


def test_every_entry_is_sent_work(monkeypatch):
    """With launch groups of two tiles, every one of three entries gets
    launches, each group to the entry with the fewest cells so far: no
    entry ends more than one group's cells behind another."""
    want = _one_entry("ga", GAPS, "1")
    monkeypatch.setattr(port_engine.Engine, "_tile_group",
                        lambda self, Lc, Lk, n: 2)
    sizes = []
    pick = port_engine.Engine._pick

    def record(self, blks):
        sizes.append(sum(b.cells for _, b in blks))
        return pick(self, blks)

    monkeypatch.setattr(port_engine.Engine, "_pick", record)
    got, stats = _run(["cpu"] * 3)
    np.testing.assert_array_equal(got, want)
    assert min(stats.lane_launches) > 0
    assert sum(stats.lane_launches) == len(sizes)
    assert max(stats.lane_cells) - min(stats.lane_cells) <= max(sizes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_cells_without_arrays(seed):
    """The cells the main thread assigns by equal each linear-v1 block's
    own count (Block.cells), rectangles and triangles, tails and blocks
    that cross rows, and build no per-pair arrays."""
    rng = np.random.default_rng(seed)
    lengths = np.r_[rng.integers(10, 17, rng.integers(2, 300)),
                    rng.integers(50, 65, rng.integers(2, 200))]
    sched = Schedule.build(lengths)
    cells = port_engine._BlockCells(sched)
    seen = 0
    for a, b in sched.combos():
        for width in (8, 37, 128, 1000):
            for blk in sched.blocks(a, b, width=width, tail_min=None):
                got = cells(blk)
                assert blk._arr is None
                assert got == blk.cells
                seen += 1
    assert seen > 20


def test_four_entries_equal_the_jax_engine_on_eight_devices():
    """The port on four CPU entries == the JAX engine on an eight-device
    CPU mesh (tests/test_engine.py's multi-device case), exactly."""
    rng = np.random.default_rng(7)
    seqs = [rng.choice(AA, int(rng.integers(4, 70))) for _ in range(60)]
    got, _ = _run(["cpu"] * 4, "ga", (0, -11, -1), seqs)
    mesh8 = ref_engine.make_mesh("cpu", 8)
    assert mesh8.devices.size == 8
    rss = RefSequenceSet.from_list(seqs, M.lut)
    store = RefOutputStore(rss.num, triangular=False, spill=False)
    ref_engine.Engine("ga", M.matrix, (0, -11, -1), mesh=mesh8,
                      target_cells=1 << 14).align_all(rss, store,
                                                      progress=False)
    np.testing.assert_array_equal(
        got, np.asarray(store.matrix).reshape(rss.num, rss.num))


@pytest.mark.parametrize("outer", ["1", "0"])
def test_schedule_token_ignores_the_entry_count(monkeypatch, outer):
    """The token of 1 to 4 entries is the one-device JAX engine's."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    rng = np.random.default_rng(8)
    ref = ref_engine.Engine("ga", M.matrix, GAPS,
                            mesh=ref_engine.make_mesh("cpu", 1),
                            use_pallas=True)
    for hi in (40, 700, 5000):
        lengths = rng.integers(1, hi, 500)
        want = ref.schedule_token(lengths)
        for k in (1, 2, 3, 4):
            eng = port_engine.Engine("ga", M.matrix, GAPS, device=["cpu"] * k)
            assert eng.schedule_token(lengths) == want


@pytest.mark.parametrize("outer", ["1", "0"])
@pytest.mark.parametrize("writer,resumer", [(1, 3), (3, 1)])
def test_journal_resumes_across_entry_counts(tmp_path, monkeypatch, outer,
                                             writer, resumer):
    """A run on ``writer`` entries, cut by limit_pairs at half the pairs
    into a sentinel-filled store, resumes on ``resumer`` entries to the
    one-entry matrix: the block ids mean the same pairs."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", 1500)
    monkeypatch.setattr(port_engine, "SYNC_INTERVAL", 0.0)
    ss = SequenceSet.from_list(_two_bucket_seqs(), M.lut)
    n = ss.num
    total = n * (n - 1) // 2
    jpath, spath = tmp_path / "run.ckpt", tmp_path / "run.scores"
    pre = ckpt.persistent_array(spath, total)
    pre[:] = SENTINEL
    pre.flush()
    del pre
    for k, limit in ((writer, total // 2), (resumer, None)):
        eng = port_engine.Engine("ga", M.matrix, GAPS, device=["cpu"] * k)
        header = ckpt.config_fingerprint(
            algo="ga", gaps=GAPS, matrix="blosum62", num_seqs=n,
            lengths=ss.lengths, triangular=True, data=ss.data,
            schedule=eng.schedule_token(ss.lengths))
        store = OutputStore(n, triangular=True, spill=False,
                            persist_path=spath)
        journal = ckpt.Journal(jpath, header)
        stats = eng.align_all(ss, store, progress=False, journal=journal,
                              limit_pairs=limit)
        journal.close()
        if limit is not None:
            assert 0 < stats.pairs < total
            assert (np.asarray(store.matrix) == SENTINEL).any()
    assert stats.pairs_resumed > 0 and stats.pairs > 0
    assert stats.pairs + stats.pairs_resumed == total
    np.testing.assert_array_equal(store.rows(0, n),
                                  _one_entry("ga", GAPS, outer))


def test_card_groups_split_a_combo_over_entries(monkeypatch):
    """On the card with several entries, a combo of more tiles than one
    card's fill goes out in a launch per entry at least; one entry keeps
    the fewest launches the flush cap allows."""
    cap = port_engine.FLUSH_PAIRS // (geometry.S_TILE * geometry.LANE)
    one = port_engine.Engine("ga", M.matrix, GAPS, device="cpu")
    two = port_engine.Engine("ga", M.matrix, GAPS, device=["cpu"] * 2)
    for eng in (one, two):
        monkeypatch.setattr(eng, "_cuda", True)
        monkeypatch.setattr(eng, "_fill_tiles", lambda dp16: 4)
    for n in (1, 8, 45, 300, 1000):
        assert one._tile_group(512, 512, n) == cuda_dp.tiles_per_launch(n,
                                                                        cap)
        g = two._tile_group(512, 512, n)
        assert -(-n // g) >= (2 if n >= 8 else 1)
        assert g >= min(n, 4)


def test_device_list_forms():
    """"cpu", a list with repeats, and refusals: no CUDA device here, an
    empty list, a mixed list."""
    assert port_engine.resolve_devices("cpu") == [torch.device("cpu")]
    assert port_engine.resolve_devices(["cpu", "cpu"]) == [
        torch.device("cpu")] * 2
    for bad in ([], ["cpu", "meta"]):
        with pytest.raises(ValueError):
            port_engine.resolve_devices(bad)
    if not torch.cuda.is_available():
        for dev in ("cuda", ["cpu", "cuda:0"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_engine.resolve_devices(dev)


def test_entry_gives_the_reference_entry_scores():
    """entry() on the CPU: 256 GA pairs of 64 x 64, the scores of the JAX
    package's entry() (its XLA wavefront) on the same draws."""
    fn, args = entry.entry("cpu")
    got = fn(*args)
    rfn, rargs = ref_entry.entry()
    want = np.asarray(rfn(*rargs))
    assert got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dryrun_multidevice_on_four_cpu_entries():
    out = entry.dryrun_multidevice(["cpu"] * 4)
    assert out["pairs"] == 300 * 299 // 2
    assert len(out["launches"]) == 4 and min(out["launches"]) > 0
