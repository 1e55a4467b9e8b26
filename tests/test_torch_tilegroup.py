"""Launch grouping of the tile stream: how the port's engine packs a combo's
tiles into tile-kernel launches on the card, and that the grouping changes
no score, block, schedule token or CPU behaviour.  Scores are compared with
the JAX package's CPU engine, exactly."""

import numpy as np
import pytest
import torch

from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu.ops import pallas_dp
from sequencealigner_tpu.scheduler import Schedule as RefSchedule
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch import flusher
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.ops import cuda_dp, geometry
from sequencealigner_tpu_torch.scheduler import Schedule

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
ALGO_GAPS = [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -9, -2))]
CAP = port_engine.FLUSH_PAIRS // (geometry.S_TILE * geometry.LANE)


def _groups(items: list, size: int) -> list:
    return [items[i : i + size] for i in range(0, len(items), size)]


@pytest.mark.parametrize("ntiles,cap", [
    (1, 256), (3, 256), (45, 256), (256, 256), (257, 256), (666, 256),
    (10, 4), (7, 1),
])
def test_tiles_per_launch_fewest_launches_within_cap(ntiles, cap):
    g = cuda_dp.tiles_per_launch(ntiles, cap)
    sizes = [len(x) for x in _groups(list(range(ntiles)), g)]
    assert max(sizes) <= cap and sum(sizes) == ntiles
    assert len(sizes) == -(-ntiles // cap)  # no more launches than needed


def test_tile_groups_concatenate_to_the_tile_stream():
    """Every combo of a 4096-protein schedule (lengths 50-500): the card's
    groups stay within the flush cap and, concatenated, are the combo's
    tiles in order; the tile stream is the reference scheduler's."""
    lengths = np.random.default_rng(1).integers(50, 501, 4096)
    sched, ref = Schedule.build(lengths), RefSchedule.build(lengths)
    launches = 0
    for a, b in sched.combos():
        tiles = list(sched.tiles(a, b))
        assert [t.desc for t in tiles] == [t.desc for t in ref.tiles(a, b)]
        groups = _groups(tiles, cuda_dp.tiles_per_launch(len(tiles), CAP))
        assert all(len(g) <= CAP for g in groups)
        assert [t for g in groups for t in g] == tiles
        launches += len(groups)
    assert launches == len(sched.combos())  # one launch per combo here


def _three_window_seqs():
    """390 proteins of 20-120 residues in two buckets whose combos hold
    three and six tiles (260 short rows span three 128-row windows)."""
    rng = np.random.default_rng(31)
    lens = np.r_[rng.integers(20, 31, 130), rng.integers(50, 64, 130),
                 rng.integers(100, 121, 130)]
    return [rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), int(n)).astype(np.uint8)
            for n in lens]


@pytest.mark.parametrize("algo,gaps", ALGO_GAPS)
def test_multi_tile_launches_match_reference_engine(monkeypatch, algo, gaps):
    """With two tiles per launch (the card's grouping put on the CPU path by
    a fixture), the port's matrix equals the JAX CPU engine's, the tiles go
    out in the reference's stream order and the schedule token is the
    reference's."""
    seqs = _three_window_seqs()
    sent = []
    dispatch = port_engine.Engine._dispatch_tiles

    def record(self, blks, ctx, pending):
        sent.append([b.desc for _, b in blks])
        return dispatch(self, blks, ctx, pending)

    monkeypatch.setattr(port_engine.Engine, "_tile_group",
                        lambda self, Lc, Lk, n: 2)
    monkeypatch.setattr(port_engine.Engine, "_dispatch_tiles", record)
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = port_engine.Engine(algo, M.matrix, gaps, device="cpu")
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, store, progress=False)
    got = np.asarray(store.matrix).reshape(ss.num, ss.num)

    ref = ref_engine.Engine(algo, M.matrix, gaps, device_kind="cpu")
    rss = RefSequenceSet.from_list(seqs, M.lut)
    rstore = RefOutputStore(rss.num, triangular=False, spill=False)
    ref.align_all(rss, rstore, progress=False)
    np.testing.assert_array_equal(
        got, np.asarray(rstore.matrix).reshape(rss.num, rss.num))

    rsched = RefSchedule.build(rss.lengths)
    stream = [t.desc for a, b in rsched.combos() for t in rsched.tiles(a, b)]
    assert [d for g in sent for d in g] == stream
    assert max(map(len, sent)) == 2 and len(sent) < len(stream)
    assert eng.schedule_token(ss.lengths) == ref_engine.Engine(
        algo, M.matrix, gaps, device_kind="cpu", use_pallas=True,
    ).schedule_token(rss.lengths)


class _BusyFlusher:
    """Stands in for the engine's flusher thread: runs its work at start()
    and reads as alive until it is joined."""

    def __init__(self, target, args=(), daemon=None):
        self._run = lambda: target(*args)

    def start(self):
        self._run()

    def is_alive(self):
        return True

    def join(self, timeout=None):
        pass


def test_flush_bound_never_cuts_a_tile_launch(monkeypatch):
    """With a flush bound of three tiles' pairs, two tiles per launch and a
    flusher that reads as busy until it is joined (so nothing is flushed
    early), each combo's tiles go out in whole groups of two (its last
    group holds the rest): a tile group that would cross the bound flushes
    before it starts instead of being cut short.  The matrix is the one of
    one tile per launch."""
    seqs = _three_window_seqs()
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    want = OutputStore(ss.num, triangular=False, spill=False)
    monkeypatch.setattr(port_engine.Engine, "_tile_group",
                        lambda self, Lc, Lk, n: 1)
    eng.align_all(ss, want, progress=False)

    sent = []
    dispatch = port_engine.Engine._dispatch_tiles

    def record(self, blks, ctx, pending):
        sent.append(len(blks))
        return dispatch(self, blks, ctx, pending)

    monkeypatch.setattr(flusher.threading, "Thread", _BusyFlusher)
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS",
                        3 * geometry.S_TILE * geometry.LANE)
    monkeypatch.setattr(port_engine.Engine, "_tile_group",
                        lambda self, Lc, Lk, n: 2)
    monkeypatch.setattr(port_engine.Engine, "_dispatch_tiles", record)
    got = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, got, progress=False)
    sched = Schedule.build(ss.lengths)
    sizes = [len(g) for a, b in sched.combos()
             for g in _groups(list(sched.tiles(a, b)), 2)]
    assert sent == sizes and max(sizes) == 2
    np.testing.assert_array_equal(np.asarray(got.matrix),
                                  np.asarray(want.matrix))


def test_linear_v1_flushes_only_at_the_bound(monkeypatch):
    """The pre-flush of tile groups does not reach linear-v1: on the wide
    route (BLOSUM62 x 20, int32 scores: linear-v1 with blocks of 1,024-4,096
    pairs) and with a flusher that reads as busy, every batch handed to it
    carries at least FLUSH_PAIRS pairs of width (only the final batch,
    flushed in line, may hold fewer), and the matrix is the JAX CPU
    engine's."""
    seqs = _three_window_seqs()
    ss = SequenceSet.from_list(seqs, M.lut)
    wide = M.matrix.astype(np.int64) * 20
    bound = 16384
    batches = []

    class Recording(_BusyFlusher):
        def __init__(self, target, args=(), daemon=None):
            batches.append(sum(b.width for e in args[0] for _, b in e.blocks))
            super().__init__(target, args, daemon)

    monkeypatch.setattr(flusher.threading, "Thread", Recording)
    monkeypatch.setattr(port_engine, "FLUSH_PAIRS", bound)
    eng = port_engine.Engine("ga", wide, (0, -10, -1), device="cpu")
    assert eng.schedule_token(ss.lengths).startswith("linear-v1")
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, store, progress=False)
    assert len(batches) >= 3 and min(batches) >= bound

    monkeypatch.undo()  # the reference engine's own flusher threads
    ref = ref_engine.Engine("ga", wide, (0, -10, -1), device_kind="cpu")
    rss = RefSequenceSet.from_list(seqs, M.lut)
    rstore = RefOutputStore(rss.num, triangular=False, spill=False)
    ref.align_all(rss, rstore, progress=False)
    np.testing.assert_array_equal(np.asarray(store.matrix),
                                  np.asarray(rstore.matrix))


def test_cpu_groups_by_pick_t_and_card_by_tiles_per_launch(monkeypatch):
    """The CPU path keeps the reference's pick_T; an engine on the card
    groups by tiles_per_launch under the flush cap."""
    eng = port_engine.Engine("ga", M.matrix, (0, -10, -1), device="cpu")
    edges = [(96, 96), (256, 160), (320, 256), (512, 512), (4096, 4096)]
    for Lc, Lk in edges:
        assert eng._tile_group(Lc, Lk, 45) == geometry.pick_T(Lc, Lk)
        assert geometry.pick_T(Lc, Lk) == pallas_dp.pick_T(Lc, Lk)
    monkeypatch.setattr(eng, "_cuda", True)
    for n in (1, 45, 300, 1000):
        assert eng._tile_group(512, 512, n) == cuda_dp.tiles_per_launch(
            n, CAP)
