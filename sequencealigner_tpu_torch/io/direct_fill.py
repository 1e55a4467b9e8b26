"""Direct scatter of launch groups into the score store.

A tiles-v2 tile is a rectangle of length-sorted bucket rows, named by its
first c row, its lane window and its two buckets; a diagonal-remainder
block is a run of slot ids in one bucket's per-window triangles; a
linear-v1 block is a run of consecutive pair ids of one bucket combo
(the triangle id rc(rc-1)/2 + rk within a bucket, rc * count_k + rk
across two), its valid ones first.  ``csrc/direct_fill.c``'s
``scatter_tiles``, ``scatter_diag`` and ``scatter_linear`` read a launch
group's score buffer as it came back from the device (int16 or int32),
work out each slot's rows from those identities, skip invalid slots, map
rows through ``Schedule.order`` and write each score into the store's
matrix: both mirrors of a full store, ``j(j-1)/2 + i`` of a triangular
one.  One ctypes call per launch group, which holds no GIL while it runs,
and no per-pair index arrays.  A call runs on a thread per tile or block
of the group, or per tile's worth of pairs of a linear-v1 group, up to the
cores the process may run on (or ``-T``'s count): the caller and helpers
of a pool that the C file keeps, which sleep between groups, so that none
waits spinning beside the engine's own threads, as an OpenMP team's idle
workers do.

``filler(store)`` gives the function that does this for ``store``, or None
where it does not apply: a store other than a plain-layout OutputStore
(the sorted-coordinate spill layout, a ShardStore), no native library
(``SEQALIGN_TPU_NATIVE=0``, no compiler) or a process that may run on two
cores or fewer (its affinity mask, as the team is sized), where
OutputStore.fill_pairs does not take the native scatter either.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from .. import buildcache, system
from ..scheduler import TILE_B, TILE_S, Block, DiagBlock, TileBlock
from .output import OutputStore

assert TILE_S == TILE_B == 128  # direct_fill.c's TILE

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "direct_fill.c"

_WIDE = {np.dtype(np.int16): 0, np.dtype(np.int32): 1}

#: The plain layout's own scatter, whose writes the direct path makes.
_FILL_PAIRS = OutputStore.fill_pairs


@functools.cache
def _library() -> ctypes.CDLL | None:
    """csrc/direct_fill.c, built into the port's build cache on first use
    (buildcache.host_library); None under SEQALIGN_TPU_NATIVE=0 or when it
    cannot be built."""
    lib = buildcache.host_library(_SRC, ("-march=native", "-pthread"))
    if lib is not None:
        vp = ctypes.c_void_p
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        lib.scatter_tiles.restype = i64
        lib.scatter_tiles.argtypes = [vp, i32, vp, i64, vp, vp, i64, i64,
                                      i64, i64, vp, i64, i32, i32]
        lib.scatter_diag.restype = i64
        lib.scatter_diag.argtypes = [vp, i32, vp, i64, i64, vp, vp, i64,
                                     i64, vp, i64, i32, i32]
        lib.scatter_linear.restype = i64
        lib.scatter_linear.argtypes = [vp, i32, vp, vp, i64, i64, vp, vp,
                                       i64, i64, i64, vp, i64, i32, i32]
    return lib


def _cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _team(units: int) -> int:
    """Threads for a group of ``units`` tiles or blocks, or tiles' worth of
    pairs: one each, up to the cores the process may run on, or to
    ``-T``'s count."""
    return max(1, min(units, system.THREAD_NUM or _cores()))


def filler(store):
    """A function ``fill(buf, blocks) -> cells`` that scatters one launch
    group's scores ``buf`` (the group's host buffer, flat, block after
    block) of ``blocks`` (all TileBlocks, all DiagBlocks of one width, or
    all linear-v1 Blocks of one combo and one width) into ``store`` and
    returns the true DP cells it wrote; None when the direct path does not
    apply to ``store``.

    A subclass of OutputStore that overrides ``fill_pairs`` keeps the
    triplet path, which calls its override; so does OutputStore itself
    while its ``fill_pairs`` is replaced on the class."""
    if (not isinstance(store, OutputStore) or store.pos is not None
            or type(store).fill_pairs is not _FILL_PAIRS):
        return None
    if _cores() <= 2:
        return None
    lib = _library()
    if lib is None:
        return None
    matrix = store.matrix
    if (matrix.dtype != np.int32 or not matrix.flags.c_contiguous
            or not matrix.flags.writeable):
        return None
    dim, tri = store.dim, int(store.triangular)
    ptr = matrix.ctypes.data

    def fill(buf: np.ndarray, blocks: list) -> int:
        buf = np.ascontiguousarray(buf)
        wide = _WIDE[buf.dtype]
        first = blocks[0]
        sch = first.sched
        order = np.ascontiguousarray(sch.order, dtype=np.int64)
        lengths = np.ascontiguousarray(sch.lengths_sorted, dtype=np.int32)
        if len(order) != dim:
            raise ValueError(f"a schedule of {len(order)} sequences into a "
                             f"store of {dim}")
        if len(buf) != sum(b.width for b in blocks):
            raise ValueError(f"{len(buf)} scores for blocks of "
                             f"{sum(b.width for b in blocks)} slots")
        if isinstance(first, TileBlock):
            bc, bk = sch.buckets[first.bucket_c], sch.buckets[first.bucket_k]
            desc = np.asarray([b.desc for b in blocks], np.int32)
            return lib.scatter_tiles(
                buf.ctypes.data, wide, desc.ctypes.data, len(blocks),
                order.ctypes.data, lengths.ctypes.data, bc.start, bc.count,
                bk.start, bk.count, ptr, dim, tri, _team(len(blocks)))
        if isinstance(first, DiagBlock):
            b = sch.buckets[first.bucket]
            starts = np.asarray([x.start for x in blocks], np.int64)
            return lib.scatter_diag(
                buf.ctypes.data, wide, starts.ctypes.data, len(blocks),
                first.width, order.ctypes.data, lengths.ctypes.data,
                b.start, b.count, ptr, dim, tri, _team(len(blocks)))
        if isinstance(first, Block):
            n = len(blocks)
            starts = np.fromiter((x.start for x in blocks), np.int64, n)
            nvalid = np.fromiter((x.n_valid for x in blocks), np.int64, n)
            if any(x.width != first.width for x in blocks):
                raise ValueError("linear-v1 blocks of unequal widths")
            npairs = sch.combo_pair_count(first.bucket_k, first.bucket_c)
            if ((nvalid > first.width).any()
                    or (starts + nvalid > npairs).any()):
                raise ValueError("linear-v1 blocks past their combo")
            bc, bk = sch.buckets[first.bucket_c], sch.buckets[first.bucket_k]
            pairs = int(nvalid.sum())
            return lib.scatter_linear(
                buf.ctypes.data, wide, starts.ctypes.data,
                nvalid.ctypes.data, n, first.width, order.ctypes.data,
                lengths.ctypes.data, bc.start, bk.start, bk.count, ptr, dim,
                tri, _team(-(-pairs // (TILE_S * TILE_B))))
        raise TypeError(f"no direct scatter for {type(first).__name__}")

    return fill
