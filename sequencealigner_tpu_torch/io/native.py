# Port of sequencealigner_tpu/io/native.py: the loaders build through buildcache.py.
"""ctypes loader for the native parser library (native/fastparse.c).

The C library is compiled on demand into the port's build cache
(buildcache.py; this package ships as source; pybind11 is deliberately
avoided — plain C ABI + ctypes keeps the toolchain requirement to just a C
compiler).  Any failure — no compiler, no source — silently falls back to
the pure-Python parsers, which are the semantic reference.  Disable with
SEQALIGN_TPU_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from .. import buildcache
from .input import ParseError

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE_DIR / "fastparse.c"


@functools.cache
def get() -> ctypes.CDLL | None:
    lib = buildcache.host_library(_SRC)
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fasta_parse.restype = ctypes.c_longlong
        lib.fasta_parse.argtypes = [
            u8p, ctypes.c_int64, i32p, ctypes.c_int32,
            u8p, i64p, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.dsv_parse_fast.restype = ctypes.c_longlong
        lib.dsv_parse_fast.argtypes = [
            u8p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_uint8,
            ctypes.c_int32, ctypes.c_int32,
            u8p, i64p, ctypes.c_int64, ctypes.c_char_p,
        ]
    return lib


def _run(fn, data: bytes, lut: np.ndarray, gap_pen: int, max_seqs: int, *extra):
    arr = np.frombuffer(data, dtype=np.uint8)
    lut32 = np.ascontiguousarray(lut, dtype=np.int32)
    out = np.empty(len(data) + 1, dtype=np.uint8)
    offsets = np.zeros(max_seqs + 1, dtype=np.int64)
    errbuf = ctypes.create_string_buffer(256)
    n = fn(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        lut32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        -int(gap_pen),
        *extra,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_seqs,
        errbuf,
    )
    if n < 0:
        raise ParseError(errbuf.value.decode())
    return [out[offsets[i] : offsets[i + 1]] for i in range(n)]


def fasta(data: bytes, lut: np.ndarray, gap_pen: int) -> list[np.ndarray] | None:
    lib = get()
    if lib is None:
        return None
    return _run(lib.fasta_parse, data, lut, gap_pen, data.count(b">") + 1)


def dsv_fast(
    data: bytes, lut: np.ndarray, gap_pen: int, delim: int, cols: int, seq_col: int
) -> list[np.ndarray] | None:
    lib = get()
    if lib is None:
        return None
    return _run(
        lib.dsv_parse_fast, data, lut, gap_pen, data.count(b"\n") + 2,
        delim, cols, seq_col,
    )


# ---- hostops: store scatter / row reconstruction / bucket packing ----------


@functools.cache
def hostops() -> ctypes.CDLL | None:
    """Loader for native/hostops.c (OpenMP host runtime ops)."""
    lib = buildcache.host_library(_NATIVE_DIR / "hostops.c",
                                  ("-march=native", "-fopenmp"))
    if lib is not None:
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        lib.fill_pairs_tri.restype = None
        lib.fill_pairs_tri.argtypes = [i32p, i64p, i64p, i32p, i64]
        lib.fill_pairs_full.restype = None
        lib.fill_pairs_full.argtypes = [i32p, i64, i64p, i64p, i32p, i64]
        lib.rows_from_tri.restype = None
        lib.rows_from_tri.argtypes = [i32p, i32p, i64, i64, i64]
        lib.pack_rows.restype = None
        lib.pack_rows.argtypes = [u8p, i64p, i64p, i64, i64, i32p,
                                  ctypes.c_int8, i8p]
        lib.materialize_block.restype = i64
        lib.materialize_block.argtypes = [i64p, i32p, i64, i64, i64,
                                          ctypes.c_int32, i64, i64, i64p, i64p]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fill_pairs_tri(matrix, i, j, s) -> bool:
    lib = hostops()
    if lib is None:
        return False
    lib.fill_pairs_tri(_ptr(matrix, ctypes.c_int32), _ptr(i, ctypes.c_int64),
                       _ptr(j, ctypes.c_int64), _ptr(s, ctypes.c_int32),
                       len(s))
    return True


def fill_pairs_full(matrix, dim, i, j, s) -> bool:
    lib = hostops()
    if lib is None:
        return False
    lib.fill_pairs_full(_ptr(matrix, ctypes.c_int32), dim,
                        _ptr(i, ctypes.c_int64), _ptr(j, ctypes.c_int64),
                        _ptr(s, ctypes.c_int32), len(s))
    return True


def rows_from_tri(tri, dim, r0, r1):
    lib = hostops()
    if lib is None:
        return None
    out = np.empty((r1 - r0, dim), dtype=np.int32)
    lib.rows_from_tri(_ptr(tri, ctypes.c_int32), _ptr(out, ctypes.c_int32),
                      dim, r0, r1)
    return out


def pack_rows(data, offsets, order, edge, lut, pad_value):
    lib = hostops()
    if lib is None:
        return None
    order = np.ascontiguousarray(order, dtype=np.int64)
    lut32 = np.ascontiguousarray(lut, dtype=np.int32)
    out = np.empty((len(order), edge), dtype=np.int8)
    lib.pack_rows(_ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
                  _ptr(order, ctypes.c_int64), len(order), edge,
                  _ptr(lut32, ctypes.c_int32), pad_value,
                  _ptr(out, ctypes.c_int8))
    return out


def materialize_block(order, lengths_sorted, a_start, a_count, b_start,
                      same, s0, nv):
    """(oi, oj, cells) for combo-local linear ids [s0, s0+nv) — the fused
    C version of scheduler.Block's pair-metadata pass; None → numpy path."""
    lib = hostops()
    if lib is None:
        return None
    oi = np.empty(nv, dtype=np.int64)
    oj = np.empty(nv, dtype=np.int64)
    cells = lib.materialize_block(
        _ptr(order, ctypes.c_int64), _ptr(lengths_sorted, ctypes.c_int32),
        a_start, a_count, b_start, 1 if same else 0, s0, nv,
        _ptr(oi, ctypes.c_int64), _ptr(oj, ctypes.c_int64))
    return oi, oj, int(cells)


def filter_resolve(sim, lost, j0, j1) -> bool:
    """Greedy filter resolution in C; sim is (j1, j1-j0) uint8, lost (>=j1,)
    uint8 updated in place."""
    lib = hostops()
    if lib is None:
        return False
    if not hasattr(lib, "_filter_resolve_typed"):
        lib.filter_resolve.restype = None
        lib.filter_resolve.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib._filter_resolve_typed = True
    lib.filter_resolve(_ptr(sim, ctypes.c_uint8), _ptr(lost, ctypes.c_uint8),
                       j0, j1)
    return True
