"""The flusher's direct scatter of launch groups on the CPU
(io/direct_fill.py; csrc/direct_fill.c's scatter_tiles, scatter_diag and
scatter_linear).

The store it fills equals, bit for bit, the store the triplet path fills
(Block.pairs, select_valid, OutputStore.fill_pairs), with the same true
cells, under tiles-v2 and linear-v1; linear-v1's triangle ids invert
exactly up to 2^24 bucket rows; where it does not apply (a merger, the
sorted-coordinate spill store, a ShardStore, SEQALIGN_TPU_NATIVE=0) the
triplet path still runs, under either schedule; a journal cut and resumed
on it gives the uncut run's store; the main thread counts
diagonal-remainder cells without pair arrays."""

import contextlib
import dataclasses
import functools
import io
import types
from unittest import mock

import numpy as np
import pytest
import torch

from sequencealigner_tpu_torch import checkpoint as ckpt
from sequencealigner_tpu_torch import engine, matrices, trace
from sequencealigner_tpu_torch.io import direct_fill, native
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore
from sequencealigner_tpu_torch.parallel.shard_store import ShardStore
from sequencealigner_tpu_torch.scheduler import (TILE_B, Block, DiagBlock,
                                                 Schedule, TileBlock)

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)
SENTINEL = -(2**31) + 7


def _direct_available():
    return direct_fill.filler(OutputStore(2, triangular=False,
                                          spill=False)) is not None


@pytest.fixture
def direct():
    """Skips where the direct path cannot run: no C compiler for
    csrc/direct_fill.c, or two cores or fewer."""
    if not _direct_available():
        pytest.skip("no native direct_fill library, or two cores or fewer")


def _lengths(rng):
    """Three buckets: 300 short (counts not multiples of 128, so tail rows
    and lanes; more than one window, so same-bucket tiles; a partial last
    diagonal window), 170 middle and 90 long."""
    return np.r_[rng.integers(4, 17, 300), rng.integers(40, 61, 170),
                 rng.integers(200, 251, 90)].astype(np.int32)


def _store(kind: str, n: int, tmp_path):
    """A sentinel-filled plain-layout store: full or triangular, in RAM,
    spilled to a temporary file or persistent."""
    tri = kind.startswith("tri")
    persist = tmp_path / f"{kind}.scores" if kind.endswith("persist") else None
    store = OutputStore(n, triangular=tri, spill=kind.endswith("spill"),
                        persist_path=persist)
    _sentinel(store)
    return store


def _sentinel(store):
    """Every pair's entry of ``store`` set to SENTINEL (a full store's
    diagonal stays 0)."""
    store.matrix[:] = SENTINEL
    if not store.triangular:
        np.fill_diagonal(store.matrix.reshape(store.dim, store.dim), 0)


def _groups(sched, rng):
    """Every launch group of the schedule, as the engine forms them: per
    combo its tiles in groups of 1-7, then a same-bucket combo's diagonal
    blocks in groups of equal width."""
    for a, b in sched.combos():
        tiles = list(sched.tiles(a, b))
        k = 0
        while k < len(tiles):
            g = int(rng.integers(1, 8))
            yield tiles[k : k + g]
            k += g
        if a != b:
            continue
        blocks = list(sched.diag_blocks(a, 3 * TILE_B, tail_min=TILE_B))
        k = 0
        while k < len(blocks):
            g = [x for x in blocks[k : k + 3] if x.width == blocks[k].width]
            yield g
            k += len(g)


def _linear_groups(sched, rng):
    """Every launch group of the schedule under linear-v1: per combo its
    blocks of one width (8 to 4,096 pairs, the last one partial; widths
    shrink at the tail where the combo has a tail unit) in groups of equal
    width, of 1 to several thousand blocks."""
    for n, (a, b) in enumerate(sched.combos()):
        width = (8, 4096, 64, 8, 512, 16)[n % 6]
        blocks = list(sched.blocks(a, b, width=width,
                                   tail_min=8 if n % 2 else None))
        k = 0
        while k < len(blocks):
            g = [x for x in blocks[k : k + int(rng.integers(1, 4000))]
                 if x.width == blocks[k].width]
            yield g
            k += len(g)


@pytest.mark.parametrize("schedule", ["tiles-v2", "linear-v1"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("kind", ["full", "tri", "full-persist",
                                  "tri-persist", "full-spill", "tri-spill"])
def test_direct_scatter_equals_the_triplet_path(direct, tmp_path, kind,
                                                dtype, schedule):
    """Every launch group of a three-bucket schedule, with random scores,
    several groups into one store: the direct scatter writes what the
    triplet path writes, nothing else, and counts the same cells."""
    rng = np.random.default_rng(5)
    sched = Schedule.build(_lengths(rng))
    n = len(sched.order)
    assert len(sched.buckets) == 3
    assert sched.buckets[0].count % TILE_B and sched.buckets[0].count > TILE_B
    mine, ref = _store(kind, n, tmp_path), _store(kind, n, tmp_path / "r")
    fill = direct_fill.filler(mine)
    lim = np.iinfo(dtype).max // 2
    cells = {"direct": 0, "triplet": 0}
    if schedule == "tiles-v2":
        groups = list(_groups(sched, rng))
        assert {type(g[0]) for g in groups} == {TileBlock, DiagBlock}
        assert any(len(g) > 1 for g in groups if isinstance(g[0], DiagBlock))
    else:
        groups = list(_linear_groups(sched, rng))
        assert {type(g[0]) for g in groups} == {Block}
        assert min(map(len, groups)) == 1 and max(map(len, groups)) > 2000
        assert any(b.n_valid < b.width for g in groups for b in g)
        combos = {(g[0].bucket_k == g[0].bucket_c) for g in groups}
        assert combos == {True, False}  # triangles and rectangles
    for g in groups:
        buf = rng.integers(-lim, lim, sum(b.width for b in g)).astype(dtype)
        cells["direct"] += fill(buf, g)
        off = 0
        for b in g:
            oi, oj, c = b.pairs()
            ref.fill_pairs(oi, oj, b.select_valid(buf[off : off + b.width])
                           .astype(np.int32))
            off += b.width
            cells["triplet"] += c
    got, want = np.asarray(mine.matrix), np.asarray(ref.matrix)
    np.testing.assert_array_equal(got, want)
    assert cells["direct"] == cells["triplet"] == sched.total_cells()
    assert not (got == SENTINEL).any()  # every pair was written


@pytest.mark.parametrize("team", [1, 2, 16])
def test_any_team_writes_the_same_store(direct, monkeypatch, team):
    """A group runs on a thread per tile or block, or per tile's worth of
    linear-v1 pairs, up to the process's cores or -T's count; a team of
    any size writes the same store and counts the same cells, under
    either schedule."""
    from sequencealigner_tpu_torch import system

    assert direct_fill._team(1) == 1
    assert direct_fill._team(10**6) == direct_fill._cores()
    monkeypatch.setattr(system, "THREAD_NUM", 2)
    assert direct_fill._team(10**6) == 2
    monkeypatch.setattr(system, "THREAD_NUM", 0)
    rng = np.random.default_rng(9)
    sched = Schedule.build(_lengths(rng))
    n = len(sched.order)
    groups = list(_groups(sched, rng)) + list(_linear_groups(sched, rng))
    bufs = [rng.integers(-9999, 9999, sum(b.width for b in g))
            .astype(np.int16) for g in groups]
    stores, cells = [], []
    for forced in (None, team):
        store = OutputStore(n, triangular=False, spill=False)
        _sentinel(store)
        with monkeypatch.context() as m:
            if forced is not None:
                m.setattr(direct_fill, "_team", lambda units: forced)
            fill = direct_fill.filler(store)
            cells.append(sum(fill(buf, g) for buf, g in zip(bufs, groups)))
        stores.append(store.matrix)
    np.testing.assert_array_equal(stores[0], stores[1])
    assert cells[0] == cells[1] == 2 * sched.total_cells()


def _tri(j: int) -> int:
    """The first triangle id of row j."""
    return j * (j - 1) // 2


ROWS = 1 << 24  # the most rows a bucket has (scheduler.BUCKET_ROWS_MAX)


@pytest.mark.parametrize("same,lin", [
    *((True, x) for x in (
        0, 1, 2, _tri(46_340) - 1, _tri(46_340), _tri(46_341) - 1,
        _tri(46_341), _tri(46_342) - 1, _tri(46_342), 2**31 - 1, 2**31,
        2**31 + 1, 2**32 + 12_345, _tri(ROWS - 1) - 1, _tri(ROWS - 1),
        _tri(ROWS) - 1)),
    *((False, x) for x in (
        0, ROWS - 1, ROWS, 2**31 - 1, 2**31 + 7, ROWS * ROWS - 1)),
], ids=lambda v: ("tri" if v else "rect") if isinstance(v, bool) else v)
def test_linear_ids_invert_exactly(direct, same, lin):
    """scatter_linear maps one pair id to its bucket rows exactly: the
    triangle (rc(rc-1)/2 + rk, rk < rc, as engine._tri_row inverts it) at
    row edges near 46,341 and 2^24 rows and past 2^31, and the rectangle
    (rc * 2^24 + rk).  Only the two rows the id names lead into the store
    and to lengths, so a wrong row writes elsewhere or counts 0 cells."""
    rc, rk = engine._tri_row(lin) if same else divmod(lin, ROWS)
    assert 0 <= rk < (rc if same else ROWS) and rc < ROWS
    c_start = 0 if same else ROWS  # a second bucket after the first
    # Zero pages but for the two rows read: 2^25 int64 and int32.
    order = np.zeros(2 * ROWS, np.int64)
    lengths = np.zeros(2 * ROWS, np.int32)
    order[c_start + rc], order[rk] = 1, 2
    lengths[c_start + rc], lengths[rk] = 3, 5
    matrix = np.full((3, 3), SENTINEL, np.int32)
    buf = np.array([777], np.int32)
    starts, nvalid = np.array([lin], np.int64), np.array([1], np.int64)
    cells = direct_fill._library().scatter_linear(
        buf.ctypes.data, 1, starts.ctypes.data, nvalid.ctypes.data, 1, 1,
        order.ctypes.data, lengths.ctypes.data, c_start, 0, ROWS,
        matrix.ctypes.data, 3, 0, 1)
    want = np.full((3, 3), SENTINEL, np.int32)
    want[1, 2] = want[2, 1] = 777
    np.testing.assert_array_equal(matrix, want)
    assert cells == 15


def _seqs():
    """190 short and 150 longer proteins: two buckets with tail rows, tiles
    within each bucket and a partial last diagonal window."""
    rng = np.random.default_rng(11)
    return [rng.choice(AA, int(x))
            for x in np.r_[rng.integers(4, 13, 190), rng.integers(40, 61, 150)]]


def _align(monkeypatch, store, *, outer="1", merger=None, wide=False,
           journal=None, limit_pairs=None):
    """(stats, run) of one traced align_all of _seqs() into ``store``."""
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    if wide:
        monkeypatch.setattr(engine.Engine, "_int16_ok",
                            lambda self, lc, lk: False)
    eng = engine.Engine("ga", M.matrix, GAPS, device="cpu")
    ss = SequenceSet.from_list(_seqs(), M.lut)
    before = trace.runs()[-1:]
    with (mock.patch.dict("os.environ", {"SEQALIGN_TPU_DEBUG_PHASES": "1"}),
          contextlib.redirect_stdout(io.StringIO())):
        stats = eng.align_all(ss, store, progress=False, merger=merger,
                              journal=journal, limit_pairs=limit_pairs)
    run, = trace.runs()[-1:]
    assert [run] != before
    return stats, run


def _scattered(run):
    spans = run.named("flush.scatter")
    return (sum(s.attrs["pairs"] for s in spans),
            sum(s.attrs["direct"] for s in spans))


N = len(_seqs())


@pytest.mark.parametrize("wide", [False, True], ids=["int16", "int32"])
@pytest.mark.parametrize("tri", [False, True], ids=["full", "tri"])
def test_engine_direct_run_equals_the_triplet_run(direct, monkeypatch, tri,
                                                  wide):
    """A tiles-v2 run through the direct path fills the store the triplet
    path fills, with equal pairs and cells; its scatter spans are all
    direct and it builds no pair arrays."""
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 8192)
    store = OutputStore(N, triangular=tri, spill=False)
    stats, run = _align(monkeypatch, store, wide=wide)
    assert _scattered(run) == (stats.pairs, stats.pairs)
    assert stats.pairs == N * (N - 1) // 2
    assert not run.named("flush.materialize")
    with monkeypatch.context() as m:
        m.setattr(direct_fill, "filler", lambda store: None)
        ref = OutputStore(N, triangular=tri, spill=False)
        ref_stats, ref_run = _align(m, ref, wide=wide)
    assert _scattered(ref_run) == (stats.pairs, 0)
    np.testing.assert_array_equal(store.matrix, ref.matrix)
    assert (stats.pairs, stats.cells) == (ref_stats.pairs, ref_stats.cells)


def _identity(i, j, s):
    return i, j, s


@pytest.mark.parametrize("wide", [False, True], ids=["int16", "int32"])
@pytest.mark.parametrize("tri", [False, True], ids=["full", "tri"])
def test_engine_direct_linear_run_equals_the_triplet_run(direct, monkeypatch,
                                                         tri, wide):
    """A linear-v1 run (SEQALIGN_TPU_OUTER=0) through the direct path fills
    the store the triplet path fills, with equal pairs and cells; every
    scatter span is direct and it builds no pair arrays."""
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 8192)
    store = OutputStore(N, triangular=tri, spill=False)
    stats, run = _align(monkeypatch, store, outer="0", wide=wide)
    assert run.top.attrs["schedule"] == "linear-v1"
    spans = run.named("flush.scatter")
    assert len(spans) > 1
    assert all(s.attrs["direct"] == s.attrs["pairs"] for s in spans)
    assert _scattered(run) == (stats.pairs, stats.pairs)
    assert stats.pairs == N * (N - 1) // 2
    assert not run.named("flush.materialize")
    with monkeypatch.context() as m:
        m.setattr(direct_fill, "filler", lambda store: None)
        ref = OutputStore(N, triangular=tri, spill=False)
        ref_stats, ref_run = _align(m, ref, outer="0", wide=wide)
    assert ref_run.named("flush.materialize")
    assert _scattered(ref_run) == (stats.pairs, 0)
    np.testing.assert_array_equal(store.matrix, ref.matrix)
    assert (stats.pairs, stats.cells) == (ref_stats.pairs, ref_stats.cells)


@pytest.mark.parametrize("case", [
    "merger", "sorted-spill", "shard-store", "no-native", "merger-linear-v1",
    "sorted-spill-linear-v1", "shard-store-linear-v1", "no-native-linear-v1"])
def test_triplet_path_where_direct_does_not_apply(monkeypatch, case):
    """Under a merger, into the sorted-coordinate spill store or a
    ShardStore and with SEQALIGN_TPU_NATIVE=0, on tiles-v2 and on
    linear-v1, every scatter is the triplet path's (``direct`` 0), and the
    store holds the plain run's scores."""
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 8192)
    plain = OutputStore(N, triangular=True, spill=False)
    want_stats, _ = _align(monkeypatch, plain)
    kw: dict = {}
    if case.endswith("-linear-v1"):
        kw["outer"] = "0"
        case = case.removesuffix("-linear-v1")
    store = OutputStore(N, triangular=True, spill=False)
    if case == "merger":
        kw["merger"] = _identity
    elif case == "sorted-spill":
        order = Schedule.build(SequenceSet.from_list(_seqs(), M.lut)
                               .lengths).order
        store = OutputStore(N, triangular=True, spill=True, perm=order)
        assert store.pos is not None
    elif case == "shard-store":
        store = ShardStore(N, 0, N)
    else:
        monkeypatch.setenv("SEQALIGN_TPU_NATIVE", "0")
        # Loaders that have not loaded yet in this process.
        for mod, name in ((native, "hostops"), (direct_fill, "_library")):
            monkeypatch.setattr(mod, name, functools.cache(
                getattr(mod, name).__wrapped__))
    assert direct_fill.filler(store) is None or case == "merger"
    stats, run = _align(monkeypatch, store, **kw)
    assert run.top.attrs["schedule"] == ("linear-v1" if "outer" in kw
                                         else "tiles-v2")
    spans = run.named("flush.scatter")
    assert spans and all(s.attrs["direct"] == 0 for s in spans)
    assert _scattered(run) == (stats.pairs, 0)
    assert (stats.pairs, stats.cells) == (want_stats.pairs, want_stats.cells)
    if case == "shard-store":
        np.testing.assert_array_equal(store.matrix, plain.matrix)
    else:
        np.testing.assert_array_equal(store.rows(0, N), plain.rows(0, N))


def test_cut_and_resumed_journal_run_equals_an_uncut_one(direct, tmp_path,
                                                         monkeypatch):
    """A direct run into a persistent store, cut by limit_pairs at about
    half the pairs and resumed from its journal, gives the uncut run's
    store bit for bit; both halves scatter directly."""
    monkeypatch.setattr(engine, "FLUSH_PAIRS", 8192)
    monkeypatch.setattr(engine, "SYNC_INTERVAL", 0.0)
    total = N * (N - 1) // 2
    full = OutputStore(N, triangular=False, spill=False)
    _align(monkeypatch, full)
    ss = SequenceSet.from_list(_seqs(), M.lut)
    token = engine.Engine("ga", M.matrix, GAPS,
                          device="cpu").schedule_token(ss.lengths)
    assert token.startswith("tiles-v2")
    header = ckpt.config_fingerprint(
        algo="ga", gaps=GAPS, matrix="blosum62", num_seqs=N,
        lengths=ss.lengths, triangular=False, data=ss.data, schedule=token)
    jpath, spath = tmp_path / "run.ckpt", tmp_path / "run.scores"
    pairs = []
    for limit in (total // 2, None):
        store = OutputStore(N, triangular=False, spill=False,
                            persist_path=spath)
        if limit is not None:
            _sentinel(store)
        journal = ckpt.Journal(jpath, header)
        stats, run = _align(monkeypatch, store, journal=journal,
                            limit_pairs=limit)
        journal.close()
        assert _scattered(run) == (stats.pairs, stats.pairs)
        pairs.append((stats.pairs, stats.pairs_resumed))
        if limit is not None:
            assert 0 < stats.pairs < total
            assert (np.asarray(store.matrix) == SENTINEL).sum() > N
    (cut, _), (rest, resumed) = pairs
    assert resumed == cut and cut + rest == total
    np.testing.assert_array_equal(np.asarray(store.matrix),
                                  np.asarray(full.matrix))


def test_filler_refuses_what_it_cannot_fill(direct):
    """No direct fill for the sorted-coordinate layout, a ShardStore, a
    store with a scatter of its own (the direct path would bypass it) or
    no store; a block of another kind, linear-v1 blocks of unequal widths
    or past their combo, and a buffer of the wrong size, are refused."""

    class Counted(OutputStore):
        def fill_pairs(self, i, j, scores):
            super().fill_pairs(i, j, scores)

    order = np.arange(5)[::-1].copy()
    assert direct_fill.filler(OutputStore(5, triangular=True, spill=True,
                                          perm=order)) is None
    assert direct_fill.filler(None) is None
    assert direct_fill.filler(ShardStore(5, 0, 5)) is None
    assert direct_fill.filler(Counted(5, triangular=False,
                                      spill=False)) is None
    sched = Schedule.build(np.arange(4, 9))
    fill = direct_fill.filler(OutputStore(5, triangular=False, spill=False))
    blk = next(sched.blocks(0, 0, width=16))
    with pytest.raises(TypeError):
        fill(np.zeros(16, np.int16),
             [types.SimpleNamespace(sched=sched, width=16)])
    with pytest.raises(ValueError):
        fill(np.zeros(24, np.int16),
             [blk, dataclasses.replace(blk, width=8, n_valid=0)])
    with pytest.raises(ValueError):
        fill(np.zeros(16, np.int16), [dataclasses.replace(blk, start=1)])
    assert fill(np.zeros(16, np.int16), [blk]) == blk.pairs()[2]
    tile = next(sched.tiles(0, 0), None) or next(
        sched.diag_blocks(0, TILE_B))
    with pytest.raises(ValueError):
        fill(np.zeros(tile.width + 1, np.int16), [tile])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diag_block_cells_without_arrays(seed):
    """The cells the main thread counts for diagonal-remainder blocks (to
    send launch groups to entries and blocks to hosts) equal each block's
    own count, over whole and partial windows and the tail window, and
    build no per-pair arrays."""
    rng = np.random.default_rng(seed)
    lengths = np.r_[rng.integers(10, 17, rng.integers(2, 400)),
                    rng.integers(50, 65, rng.integers(64, 300))]
    sched = Schedule.build(lengths)
    cells = engine._BlockCells(sched)
    seen = 0
    for a in range(len(sched.buckets)):
        for width in (TILE_B, 3 * TILE_B, 4096, 40000):
            for blk in sched.diag_blocks(a, width, tail_min=TILE_B):
                got = cells(blk)
                assert blk._arr is None
                assert got == blk.cells
                seen += 1
    assert seen > 10
