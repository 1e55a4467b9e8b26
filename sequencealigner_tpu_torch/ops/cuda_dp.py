"""Wrappers, build and ctypes binding of the Hopper DP kernels
(csrc/align_dp.cu).

``align_tiles`` and ``align_pairs`` take the contracts of their plain
versions in ops/torch_dp.py.  For tensors on the CPU they call the plain
version; for CUDA tensors they launch the kernel on the current stream (or
raise): there is no fallback.  Each wrapper counts its launches in a plain
integer attribute, ``align_tiles.launches`` / ``align_pairs.launches``.
The wrappers check devices, dtypes, shapes and contiguity; the row indices
inside ``desc`` / ``rc`` / ``rk`` are trusted (the engine derives them from
the schedule), since reading them back would synchronise the stream.

The kernels are compiled on the first CUDA call, from the package's own
``csrc/*.cu`` only, with nvcc into a shared library with a plain C interface
(no PyTorch headers: the build takes seconds).  The library lands in
``_build/`` beside the package, keyed by a hash of the sources so that an
edit rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import torch_dp
from .geometry import LANE, S_TILE

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"
#: Rows per register band in the kernels (csrc/align_dp.cu KB): pairs with
#: more rows than this hand rows between bands through the scratch stream.
KB = 32
#: Upper bound on one launch's band-crossing scratch.
SCRATCH_BYTES = 2 << 30
#: Resident blocks per SM the grid is sized for.
BLOCKS_PER_SM = 8

ALGO_ID = {"nw": 0, "ga": 1, "sw": 2}

_lib = None
_lock = threading.Lock()
#: Seconds the last build took (0.0 when the library was already built) and
#: nvcc's register/spill report for it.
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sorted(SRC_DIR.glob("*.cu"))
        h = hashlib.sha256(ARCH.encode())
        for s in srcs:
            h.update(s.read_bytes())
        so = BUILD_DIR / f"libalign_dp-{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            r = subprocess.run(
                [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
                 *map(str, srcs)],
                capture_output=True, text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{r.stderr}")
            tmp.replace(so)
            build_seconds = time.perf_counter() - t0
            build_log = r.stderr
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.align_dp_tiles.argtypes = [
            p, i, p, i, p, i, p, p, p, i, p, p, i, i, p,
        ]
        lib.align_dp_tiles.restype = i
        lib.align_dp_pairs.argtypes = [
            p, i, p, i, p, p, p, p, i, p, p, i, p, p, i, i, p,
        ]
        lib.align_dp_pairs.restype = i
        lib.align_dp_error_string.argtypes = [i]
        lib.align_dp_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(name: str, t: torch.Tensor, dtype, dev, ndim: int) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _grid_and_scratch(items: int, wmax: int, banded: bool, dev):
    """Grid size (blocks loop over items) and the band-crossing scratch:
    two int32 streams (H, Y) of wmax columns x LANE lanes per block.  The
    wrapper drops its reference right after the launch: the caching
    allocator hands the memory only to later work on the same stream."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(items, sms * BLOCKS_PER_SM)
    if not banded:
        return grid, torch.empty(1, dtype=torch.int32, device=dev), 0
    per_block = 2 * wmax * LANE * 4
    grid = max(1, min(grid, max(sms, SCRATCH_BYTES // per_block)))
    scratch = torch.empty(grid * 2 * wmax * LANE, dtype=torch.int32,
                          device=dev)
    return grid, scratch, wmax


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.align_dp_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def align_tiles(desc, cwords, kmatT, klens, sub, gaps, *, algo: str):
    """NW/GA/SW scores of T outer-product tiles -> (T, S_TILE, LANE) int32
    (contract: torch_dp.align_tiles_plain)."""
    if desc.device.type == "cpu":
        return torch_dp.align_tiles_plain(
            desc, cwords, kmatT, klens, sub, gaps, algo=algo
        )
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
    with torch.cuda.device(dev):
        grid, scratch, wmax = _grid_and_scratch(
            T * S_TILE, wmax, kmatT.shape[0] > KB, dev
        )
        err = lib.align_dp_tiles(
            desc.data_ptr(), T, cwords.data_ptr(), cwords.shape[1],
            kmatT.data_ptr(), kmatT.shape[1], klens.data_ptr(),
            sub.data_ptr(), gaps.data_ptr(), ALGO_ID[algo], out.data_ptr(),
            scratch.data_ptr(), wmax, grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "align_tiles")
    align_tiles.launches += 1
    return out


align_tiles.launches = 0


def align_pairs(mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, *,
                algo: str):
    """NW/GA/SW scores of P arbitrary bucket-row pairs -> (P,) int32
    (contract: torch_dp.align_pairs_plain)."""
    if rc.device.type == "cpu":
        return torch_dp.align_pairs_plain(
            mat_c, mat_k, rc, rk, lens_c, lens_k, sub, gaps, algo=algo
        )
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
    with torch.cuda.device(dev):
        grid, scratch, wmax = _grid_and_scratch(
            -(-n // LANE), mat_c.shape[1], mat_k.shape[1] > KB, dev
        )
        err = lib.align_dp_pairs(
            mat_c.data_ptr(), mat_c.shape[1], mat_k.data_ptr(),
            mat_k.shape[1], rc.data_ptr(), rk.data_ptr(), lens_c.data_ptr(),
            lens_k.data_ptr(), n, sub.data_ptr(), gaps.data_ptr(),
            ALGO_ID[algo], out.data_ptr(), scratch.data_ptr(), wmax, grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "align_pairs")
    align_pairs.launches += 1
    return out


align_pairs.launches = 0
