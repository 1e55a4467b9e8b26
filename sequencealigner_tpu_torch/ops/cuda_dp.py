"""Wrappers, build and ctypes binding of the Hopper DP kernels
(csrc/align_dp.cu).

``align_tiles``, ``align_pairs`` and ``align_grid`` take the contracts of
their plain versions in ops/torch_dp.py.  For tensors on the CPU they call
the plain version; for CUDA tensors they launch the kernel on the current
stream of the tensors' device (or raise): there is no fallback.  Each
wrapper counts its launches in a plain integer attribute, e.g.
``align_tiles.launches``, and per device in ``launches_by_device`` (keyed
by ``str(device)``), under the module's lock: the engine launches on
several devices, and a caller may launch from several threads.
``align_tiles`` and ``align_pairs`` also take an ``on_launch`` callback, to
which they give the lanes per pair and the waves of the layout they ran,
computed on the host from the shapes and the card, and the bits of the
form they ran.  The wrappers
check devices, dtypes, shapes and contiguity; the row indices inside
``desc`` / ``rc`` / ``rk`` and the lengths are trusted (the engine derives
them from the schedule), since reading them back would synchronise the
stream.

Grid and scratch: every kernel launches a persistent grid of SMs x its
resident blocks per SM (``tiles_resident``, ``pairs_resident``,
``grid_resident``: the CUDA occupancy query for its registers and shared
memory), whose blocks (tile and grid kernels) or warps (per-pair kernel)
take items from a device counter that the wrapper zeroes on the launch's
stream, highest index first.  The grid is capped by the items, and each
block owns one band-crossing scratch row of two int32 streams x the
widest column count (rounded up to a group of four, the kernels' [column /
4][slot][4] layout) x its stream slots, so the scratch is sized by the grid
(at most ``SCRATCH_BYTES`` unless one block per SM needs more), never by
the pair count.  The engine sends a combo's tiles in as few launches as the
flush cap allows (``tiles_per_launch``), so that each launch keeps every
resident block busy.

Grid mode: ``align_grid``'s blocks stage the int8 grid through a ring of
``GRID_STAGES`` stages of shared memory, copied by a producer warp in the
form ``grid_form`` picks from B and the grid's base alignment (``bulk``: one
bulk copy a column; ``async``: cp.async of 16, 8 or 4 bytes; ``bytes``:
plain loads); ``grid_layout`` is the whole launch.

The tile kernel's 16-bit form: ``align_tiles(..., dp16=True)`` runs
``tiles_kernel16``, which scores two k-lanes a thread in the two halfwords
of int16x2 DPX lanes (the same recurrences, two cells an instruction),
where the caller has proven that no value of the combo leaves int16
(``Engine._dp16_ok``).  Output, layout and dtype are the int32 form's.
Its block takes two c-rows of a tile (S_TILE / 2 items a tile) and holds a
62.5 KB table of row-letter pairs, so its resident count is its own
(``tiles_resident(algo, dp16=True)``).

Lanes per pair: ``align_pairs`` scores a pair with one lane (128 slots a
block) or, where the launch has too few pairs to fill the card, with a
group of G lanes of one warp, lane t holding band t of each stripe of G
bands (128 / G slots a block: one per group).  ``pair_lanes`` picks G from
the pair count, the k edge and the card alone (``pairs_layout`` the whole
launch); there is no setting.

The kernels are compiled on the first CUDA call, from the package's own
``csrc/*.cu`` only, with nvcc into a shared library with a plain C interface
(no PyTorch headers: the build takes seconds), in the port's build cache
(buildcache.py: never inside the package, which may be read-only).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
import time
from pathlib import Path

import torch

from .. import buildcache
from . import torch_dp
from .geometry import LANE, S_TILE

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
ARCH = "arch=compute_90a,code=sm_90a"
#: Rows per register band in the kernels (csrc/align_dp.cu KB): pairs with
#: more rows than this hand rows between bands through the scratch stream.
KB = 32
#: Upper bound on one launch's band-crossing scratch, unless one block per
#: SM needs more.  A block holds 2 * 128 * 4 B = 1 KiB per column (16 MiB
#: at 16,384 columns) and the grid keeps at least one block per SM (132 on
#: an H100), so the scratch needs 132 KiB per column of the longest edge:
#: an edge of about 500,000 columns is the most an 80 GB card admits (the
#: kernels have no W_MAX; lengths and in-band offsets are int32).
SCRATCH_BYTES = 2 << 30
#: Ring stages of the grid kernel (csrc/align_dp.cu STAGES): a stage is one
#: group of four columns of one KB-row band of 128 lanes.
GRID_STAGES = 4
#: Bytes of one stage, and the grid kernel's dynamic shared memory: the
#: stages' two mbarriers of 8 bytes each, then the ring (GRID_SMEM).
STAGE_BYTES = 4 * KB * LANE
GRID_SMEM = 2 * GRID_STAGES * 8 + GRID_STAGES * STAGE_BYTES
#: How the grid kernel copies a stage (csrc/align_dp.cu FORM_*).
GRID_FORMS = ("bulk", "async", "bytes")
#: Threads of a warp; the per-pair kernel's items are per warp.
WARP = 32
#: Most lanes per pair of the per-pair kernel's split form (one warp).
MAX_LANES = 32

ALGO_ID = {"nw": 0, "ga": 1, "sw": 2}

_lock = threading.Lock()
#: (kernel, device index, algo[, split]) -> resident blocks per SM.
_resident: dict = {}
#: Seconds the last build took (0.0 when the library was already in the
#: cache) and nvcc's register/spill report for it.
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(srcs) -> list:
    """nvcc's command line, but for its output, that builds ``srcs`` into
    a shared library for ``ARCH`` and reports registers (-Xptxas -v)."""
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *map(str, srcs)]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash, into the build cache) and load the
    kernel library."""
    global build_seconds, build_log
    srcs = sorted(SRC_DIR.glob("*.cu"))
    so = buildcache.library_path("align_dp", ARCH.encode(),
                                 *(s.read_bytes() for s in srcs))
    t0 = time.perf_counter()
    log = buildcache.build(so, nvcc_command(srcs))
    if log is None:
        build_seconds = 0.0
    else:
        build_seconds, build_log = time.perf_counter() - t0, log
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.align_dp_tiles.argtypes = [
        p, i, p, i, p, i, p, p, p, i, p, p, i, p, i, p,
    ]
    lib.align_dp_tiles.restype = i
    lib.align_dp_tiles_resident.argtypes = [i, p]
    lib.align_dp_tiles_resident.restype = i
    lib.align_dp_tiles16.argtypes = lib.align_dp_tiles.argtypes
    lib.align_dp_tiles16.restype = i
    lib.align_dp_tiles16_resident.argtypes = [i, p]
    lib.align_dp_tiles16_resident.restype = i
    lib.align_dp_pairs.argtypes = [
        p, i, p, i, p, p, p, p, i, p, p, i, p, p, i, i, p, i, p,
    ]
    lib.align_dp_pairs.restype = i
    lib.align_dp_pairs_resident.argtypes = [i, i, p]
    lib.align_dp_pairs_resident.restype = i
    lib.align_dp_grid.argtypes = [
        p, i, i, i, i, p, p, p, i, p, p, i, i, i, p, i, p,
    ]
    lib.align_dp_grid.restype = i
    lib.align_dp_grid_resident.argtypes = [i, p]
    lib.align_dp_grid_resident.restype = i
    lib.align_dp_error_string.argtypes = [i]
    lib.align_dp_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype, dev, ndim: int) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def launch_layout(items: int, wmax: int, banded: bool, sms: int,
                  per_sm: int, slots: int = LANE):
    """(grid, wmax, scratch int32 count) of one launch: at most ``per_sm``
    blocks per SM and one per item; when ``banded``, each block owns two
    int32 streams (H, Y) of wmax columns, rounded up to a multiple of four,
    x ``slots`` stream slots, and the grid keeps that scratch within
    ``SCRATCH_BYTES`` unless one block per SM needs more.  Pure: the sizes
    depend on the shapes and the card only."""
    grid = max(1, min(items, sms * per_sm))
    if not banded:
        return grid, 0, 0
    wmax = -(-wmax // 4) * 4
    per_block = 2 * wmax * slots
    grid = max(1, min(grid, max(sms, SCRATCH_BYTES // (4 * per_block))))
    return grid, wmax, grid * per_block


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _grid_and_scratch(items: int, wmax: int, banded: bool, dev,
                      per_sm: int):
    """``launch_layout`` on ``dev``, with the scratch allocated.  The
    wrapper drops its reference right after the launch: the caching
    allocator hands the memory only to later work on the same stream."""
    grid, wmax, n = launch_layout(items, wmax, banded, _sms(dev), per_sm)
    return grid, torch.empty(max(1, n), dtype=torch.int32, device=dev), wmax


def _occupancy(key, query, what: str) -> int:
    if key not in _resident:
        lib = load_library()
        n = ctypes.c_int(0)
        _raise_on(lib, query(lib, ctypes.byref(n)), what)
        _resident[key] = max(1, n.value)
    return _resident[key]


def tiles_resident(algo: str, dp16: bool = False) -> int:
    """Resident blocks per SM of the tile kernel for ``algo``, in its int32
    or its 16-bit form (the CUDA occupancy query for its registers and
    shared memory), on the current device."""
    return _occupancy(
        ("tiles", torch.cuda.current_device(), algo, dp16),
        lambda lib, n: (lib.align_dp_tiles16_resident if dp16
                        else lib.align_dp_tiles_resident)(ALGO_ID[algo], n),
        "align_tiles occupancy query")


def pairs_resident(algo: str, split: bool) -> int:
    """Resident blocks per SM of the per-pair kernel for ``algo``, in its
    one-lane or its split form, on the current device."""
    return _occupancy(
        ("pairs", torch.cuda.current_device(), algo, split),
        lambda lib, n: lib.align_dp_pairs_resident(ALGO_ID[algo],
                                                   int(split), n),
        "align_pairs occupancy query")


def grid_resident(algo: str) -> int:
    """Resident blocks per SM of the grid kernel for ``algo``, on the current
    device."""
    return _occupancy(
        ("grid", torch.cuda.current_device(), algo),
        lambda lib, n: lib.align_dp_grid_resident(ALGO_ID[algo], n),
        "align_grid occupancy query")


def grid_form(B: int, align: int) -> tuple:
    """(form, copy unit in bytes) of the grid kernel for B lanes a
    superblock row and a grid whose base address is a multiple of
    ``align``: ``bulk`` where a column's rows of one chunk are contiguous
    and 16-byte aligned (B = 128), else ``async`` (cp.async of the widest
    of 16, 8 and 4 bytes that B and the base allow) or ``bytes``."""
    a = 16
    while B % a or align % a:
        a //= 2
    if a == 16 and B == LANE:
        return "bulk", 16
    if a >= 4:
        return "async", a
    return "bytes", 1


def grid_layout(S: int, W: int, Kpad: int, B: int, align: int, sms: int,
                resident: int) -> dict:
    """One align_grid launch: its copy form and unit, ring stages, dynamic
    shared memory, grid (SMs x ``resident`` blocks, at most one per item of
    one superblock row's 128-lane chunk), scratch width and int32 count.
    Pure: it depends on the shapes and the card only."""
    form, unit = grid_form(B, align)
    grid, wmax, n = launch_layout(S * -(-B // LANE), W, Kpad > KB, sms,
                                  resident)
    return {"form": form, "unit": unit, "stages": GRID_STAGES,
            "smem": GRID_SMEM, "grid": grid, "wmax": wmax, "scratch": n}


def grid_launch_layout(sk, algo: str) -> dict:
    """``grid_layout`` of ``align_grid`` on the CUDA grid ``sk`` for
    ``algo``, on sk's device."""
    S, W, Kpad, B = sk.shape
    with torch.cuda.device(sk.device):
        return grid_layout(S, W, Kpad, B, sk.data_ptr() & -sk.data_ptr(),
                           _sms(sk.device), grid_resident(algo))


def pair_lanes(npairs: int, edge_k: int, sms: int, resident: int) -> int:
    """Lanes per pair (G) of one align_pairs launch of ``npairs`` pairs
    whose k bucket has ``edge_k`` rows, on a card of ``sms`` SMs holding
    ``resident`` one-lane blocks each: the smallest power of two for which
    npairs x G lanes fill that resident grid once, at most ``MAX_LANES`` and
    at most the edge's bands of KB rows (more would give a lane no rows).
    Long pairs in small launches get many lanes; a launch of more pairs
    never gets more.  (Filling it twice over, or half, measured slower on
    the H100 across long DNA, the diagonal remainder and linear-v1: PERF.md
    §6.)"""
    fill = sms * resident * LANE
    bands = -(-edge_k // KB)
    g = 1
    while g < MAX_LANES and 2 * g <= bands and npairs * g < fill:
        g *= 2
    return g


def pairs_layout(npairs: int, edge_c: int, edge_k: int, sms: int,
                 resident: tuple):
    """(G, grid, wmax, scratch int32 count) of one align_pairs launch;
    ``resident`` is the (one-lane, split) forms' blocks per SM.  Items are
    per warp (WARP / G pairs each), four warps to a block; the scratch has
    one stream slot per group of G lanes."""
    g = pair_lanes(npairs, edge_k, sms, resident[0])
    blocks = -(-_pair_items(npairs, g) // (LANE // WARP))
    grid, wmax, n = launch_layout(blocks, edge_c, edge_k > KB, sms,
                                  resident[g > 1], LANE // g)
    return g, grid, wmax, n


def _pair_items(npairs: int, g: int) -> int:
    """Warp items of an align_pairs launch of G lanes a pair."""
    return -(-npairs // (WARP // g))


def pairs_waves(npairs: int, g: int, edge_c: int, edge_k: int, sms: int,
                resident: tuple) -> float:
    """Waves of an align_pairs launch of ``pairs_layout``'s G: its warp
    items over the warps of the largest grid its form (one-lane or split)
    holds resident on the card, SMs x ``resident[g > 1]`` blocks as the
    scratch allows, four warps each.  Below 1 part of the card idles;
    above it the last wave runs ``waves % 1`` full."""
    per_sm = resident[g > 1]
    cap = launch_layout(sms * per_sm, edge_c, edge_k > KB, sms, per_sm,
                        LANE // g)[0]
    return _pair_items(npairs, g) / (cap * (LANE // WARP))


def tile_items(ntiles: int, dp16: bool = False) -> int:
    """Block items of an align_tiles launch of ``ntiles`` tiles: a c-row of
    a tile each, or two in the 16-bit form."""
    return ntiles * S_TILE // (2 if dp16 else 1)


def tiles_waves(ntiles: int, wmax: int, banded: bool, sms: int,
                per_sm: int, dp16: bool = False) -> float:
    """Waves of an align_tiles launch of ``ntiles`` tiles: its block items
    over the largest grid the card holds resident (``launch_layout``) of
    the form it runs (``per_sm`` that form's resident blocks)."""
    cap = launch_layout(sms * per_sm, wmax, banded, sms, per_sm)[0]
    return tile_items(ntiles, dp16) / cap


def tiles_per_launch(ntiles: int, cap: int) -> int:
    """Tiles per ``align_tiles`` launch for a combo of ``ntiles`` tiles: the
    fewest launches of at most ``cap`` tiles, one group size for all of
    them.  Blocks take items from a work counter, so any launch of at least
    SMs x resident blocks items fills the card (a tile is 128 items: on an
    H100, 3-5 tiles), and each launch ends with one tail in which the SMs
    drain: fewer launches, fewer tails."""
    n = max(1, -(-ntiles // max(1, cap)))
    return max(1, -(-ntiles // n))


def _count(kernel, dev) -> None:
    """One launch of ``kernel`` on ``dev``, in both of its counters."""
    by_device = kernel.launches_by_device
    with _lock:
        kernel.launches += 1
        by_device[str(dev)] = by_device.get(str(dev), 0) + 1


def tiles_to_fill(dev, algo: str, dp16: bool = False) -> int:
    """Tiles an align_tiles launch of the int32 or 16-bit form needs on
    ``dev`` so that every resident block of its grid gets an item."""
    with torch.cuda.device(dev):
        return -(-_sms(dev) * tiles_resident(algo, dp16)
                 // tile_items(1, dp16))


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.align_dp_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def align_tiles(desc, cwords, kmatT, klens, sub, gaps, *, algo: str,
                dp16: bool = False, on_launch=None):
    """NW/GA/SW scores of T outer-product tiles -> (T, S_TILE, LANE) int32
    (contract: torch_dp.align_tiles_plain).  ``dp16``: run the 16-bit form,
    which the caller may ask for only where no value of the launch's combo
    leaves int16 (``Engine._dp16_ok``); on the CPU it changes nothing.
    ``on_launch``, where given, is called after the launch with (1,
    ``tiles_waves``, the form's bits: 16 or 32); on the CPU with (1, 0.0,
    32), since the plain version has no grid and computes in int32."""
    if desc.device.type == "cpu":
        out = torch_dp.align_tiles_plain(
            desc, cwords, kmatT, klens, sub, gaps, algo=algo
        )
        if on_launch:
            on_launch(1, 0.0, 32)
        return out
    dev = desc.device
    if dev.type != "cuda":
        raise ValueError(f"align_tiles runs on CUDA or CPU tensors, not {dev}")
    _check("desc", desc, torch.int32, dev, 2)
    _check("cwords", cwords, torch.int32, dev, 2)
    _check("kmatT", kmatT, torch.int8, dev, 2)
    _check("klens", klens, torch.int32, dev, 2)
    _check("sub", sub, torch.int32, dev, 2)
    _check("gaps", gaps, torch.int32, dev, 1)
    if desc.shape[1] != 2 or sub.shape != (25, 25) or gaps.shape != (3,):
        raise ValueError("bad desc/sub/gaps shape")
    if kmatT.shape[1] % LANE or klens.shape != (1, kmatT.shape[1]):
        raise ValueError("kmatT/klens must cover whole 128-lane tiles")
    T = desc.shape[0]
    out = torch.empty((T, S_TILE, LANE), dtype=torch.int32, device=dev)
    if T == 0:
        return out
    lib = load_library()
    wmax = (cwords.shape[1] - 1) * 4
    launch = lib.align_dp_tiles16 if dp16 else lib.align_dp_tiles
    with torch.cuda.device(dev):
        per_sm = tiles_resident(algo, dp16)
        grid, scratch, wmax = _grid_and_scratch(
            tile_items(T, dp16), wmax, kmatT.shape[0] > KB, dev, per_sm,
        )
        # The work counter, zeroed on the launch's stream.
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = launch(
            desc.data_ptr(), T, cwords.data_ptr(), cwords.shape[1],
            kmatT.data_ptr(), kmatT.shape[1], klens.data_ptr(),
            sub.data_ptr(), gaps.data_ptr(), ALGO_ID[algo], out.data_ptr(),
            scratch.data_ptr(), wmax, nxt.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "align_tiles")
    _count(align_tiles, dev)
    if on_launch:
        on_launch(1, tiles_waves(T, wmax, kmatT.shape[0] > KB, _sms(dev),
                                 per_sm, dp16), 16 if dp16 else 32)
    return out


align_tiles.launches = 0
align_tiles.launches_by_device = {}


def align_pairs(mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, *,
                algo: str, on_launch=None):
    """NW/GA/SW scores of P arbitrary bucket-row pairs -> (P,) int32
    (contract: torch_dp.align_pairs_plain).  ``on_launch``, where given, is
    called after the launch with the (G, ``pairs_waves``) it ran; on the
    CPU with (1, 0.0), since the plain version scores each pair whole."""
    if rc.device.type == "cpu":
        out = torch_dp.align_pairs_plain(
            mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, algo=algo
        )
        if on_launch:
            on_launch(1, 0.0)
        return out
    dev = rc.device
    if dev.type != "cuda":
        raise ValueError(f"align_pairs runs on CUDA or CPU tensors, not {dev}")
    _check("mat_c", mat_c, torch.int8, dev, 2)
    _check("mat_k", mat_k, torch.int8, dev, 2)
    _check("rc", rc, torch.int32, dev, 1)
    _check("rk", rk, torch.int32, dev, 1)
    _check("lens_c", lens_c, torch.int32, dev, 1)
    _check("lens_k", lens_k, torch.int32, dev, 1)
    _check("sub", sub, torch.int32, dev, 2)
    _check("gaps", gaps, torch.int32, dev, 1)
    if rk.shape != rc.shape or sub.shape != (25, 25) or gaps.shape != (3,):
        raise ValueError("bad rc/rk/sub/gaps shape")
    n = rc.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    wc, wk = mat_c.shape[1], mat_k.shape[1]
    with torch.cuda.device(dev):
        sms = _sms(dev)
        resident = (pairs_resident(algo, False), pairs_resident(algo, True))
        g, grid, wmax, nscratch = pairs_layout(n, wc, wk, sms, resident)
        scratch = torch.empty(max(1, nscratch), dtype=torch.int32,
                              device=dev)
        # The work counter, zeroed on the launch's stream.
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.align_dp_pairs(
            mat_c.data_ptr(), wc, mat_k.data_ptr(), wk, rc.data_ptr(),
            rk.data_ptr(), lens_c.data_ptr(), lens_k.data_ptr(), n,
            sub.data_ptr(), gaps.data_ptr(), ALGO_ID[algo], out.data_ptr(),
            scratch.data_ptr(), wmax, g, nxt.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "align_pairs")
    _count(align_pairs, dev)
    if on_launch:
        on_launch(g, pairs_waves(n, g, wc, wk, sms, resident))
    return out


align_pairs.launches = 0
align_pairs.launches_by_device = {}


def align_grid(sk, l1, l2, gaps, *, algo: str):
    """NW/GA/SW scores of the S*B pairs of a prebuilt (S, W, Kpad, B) int8
    score grid -> (S*B,) int32 (contract: torch_dp.align_grid_plain)."""
    if sk.device.type == "cpu":
        return torch_dp.align_grid_plain(sk, l1, l2, gaps, algo=algo)
    dev = sk.device
    if dev.type != "cuda":
        raise ValueError(f"align_grid runs on CUDA or CPU tensors, not {dev}")
    _check("sk", sk, torch.int8, dev, 4)
    _check("l1", l1, torch.int32, dev, 1)
    _check("l2", l2, torch.int32, dev, 1)
    _check("gaps", gaps, torch.int32, dev, 1)
    S, W, Kpad, B = sk.shape
    n = S * B
    if l1.shape != (n,) or l2.shape != (n,) or gaps.shape != (3,):
        raise ValueError("bad l1/l2/gaps shape")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        lay = grid_launch_layout(sk, algo)
        scratch = torch.empty(max(1, lay["scratch"]), dtype=torch.int32,
                              device=dev)
        # The work counter, zeroed on the launch's stream.
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.align_dp_grid(
            sk.data_ptr(), S, W, Kpad, B, l1.data_ptr(), l2.data_ptr(),
            gaps.data_ptr(), ALGO_ID[algo], out.data_ptr(),
            scratch.data_ptr(), lay["wmax"], GRID_FORMS.index(lay["form"]),
            lay["unit"], nxt.data_ptr(),
            lay["grid"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "align_grid")
    _count(align_grid, dev)
    return out


align_grid.launches = 0
align_grid.launches_by_device = {}
