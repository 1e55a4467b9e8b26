"""Where and how every compiled library of the port is built and cached:
the host libraries gcc builds (io/native.py, io/direct_fill.py) and the
CUDA libraries nvcc builds (ops/cuda_dp.py, tools/dpx_rate.py).

They share one directory, ``cache_dir()``, each named by a hash of its
sources (``lib<stem>-<sha16>[-<isa>].so``), so that an edit rebuilds and a
later process loads what an earlier one built.  ``build`` compiles to a
name of this host and process and renames the result into place, so
processes that build one library at once into one cache (test workers,
ranks on one host, hosts over one home directory) each end with the
library and none sees a partial file.  Each library's loader is a
``functools.cache`` of its module: one load a process.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import platform
import shutil
import socket
import subprocess
import tempfile
import threading
from pathlib import Path

from . import ui

#: The build directory when SEQALIGN_TPU_CACHE is unset.
DEFAULT_CACHE = "~/.cache/sequencealigner-tpu"

#: This process's build directory when there is no persistent cache.
_private: Path | None = None
#: Caches found unusable in this process (each is warned of once).
_unusable: set = set()
_build_lock = threading.Lock()


def _private_dir() -> Path:
    """A temporary directory of this process, removed at its exit."""
    global _private
    if _private is None:
        _private = Path(tempfile.mkdtemp(prefix="seqalign-kernels-"))
        atexit.register(shutil.rmtree, _private, True)
    return _private


def cache_dir() -> Path:
    """The directory compiled libraries go to, resolved at each build (not
    at import) from SEQALIGN_TPU_CACHE, as the JAX package resolves its
    compilation cache: unset, ``DEFAULT_CACHE``; a path, that path; "0" or
    empty, no persistent cache (a private directory removed at exit).  A
    directory that cannot be created or written is not an error: one
    warning a process, then the private directory.  Either way the same
    sources are built by the same compiler."""
    val = os.environ.get("SEQALIGN_TPU_CACHE")
    if val is None:
        val = os.path.expanduser(DEFAULT_CACHE)
    if val in ("", "0"):
        return _private_dir()
    path = Path(val)
    try:
        path.mkdir(parents=True, exist_ok=True)
        if not os.access(path, os.W_OK | os.X_OK):
            raise PermissionError("not writable")
    except OSError as e:
        if path not in _unusable:
            _unusable.add(path)
            ui.pwarn("Kernel cache %s cannot be used (%s): building into "
                     "a private directory", path, e)
        return _private_dir()
    return path


@functools.cache
def host_isa_tag() -> str:
    """Identify the host ISA for -march=native cache keys: a cache directory
    shared across heterogeneous machines (NFS home, reused container volumes)
    must not serve a binary compiled for a newer CPU (SIGILL on older ones).
    gcc's resolved -march=native target is the authoritative token."""
    try:
        out = subprocess.run(
            ["gcc", "-march=native", "-E", "-v", "-", "-o", os.devnull],
            input=b"", capture_output=True, timeout=10,
        ).stderr.decode(errors="replace")
        for line in out.splitlines():
            if "-march=" in line and "native" not in line:
                arch = [t for t in line.split() if t.startswith("-march=")]
                if arch:
                    return hashlib.sha256(
                        (platform.machine() + arch[0]).encode()
                    ).hexdigest()[:8]
    except Exception:
        pass
    return platform.machine()


def library_path(stem: str, *sources: bytes, isa: bool = False) -> Path:
    """``cache_dir()``'s ``lib<stem>-<sha16 of the sources>.so``, with
    ``-<host ISA>`` before ``.so`` for a build under -march=native."""
    tag = hashlib.sha256(b"".join(sources)).hexdigest()[:16]
    if isa:
        tag += "-" + host_isa_tag()
    return cache_dir() / f"lib{stem}-{tag}.so"


def build(so: Path, command: list) -> str | None:
    """Run ``command`` with ``-o`` a name of this host and process beside
    ``so``, then rename that file to ``so``; returns the compiler's
    diagnostics, or None when ``so`` was already there.  Raises
    RuntimeError when the compiler fails."""
    tmp = so.with_name(f"{so.name}.{socket.gethostname()}.{os.getpid()}.tmp")
    with _build_lock:
        if so.exists():
            return None
        try:
            r = subprocess.run([*map(str, command), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{command[0]} failed:\n{r.stderr}")
            tmp.replace(so)
        finally:
            tmp.unlink(missing_ok=True)
    return r.stderr


def host_library(src: Path, flags: tuple = ()) -> ctypes.CDLL | None:
    """The shared library gcc builds from the C file ``src`` with
    ``flags`` into ``library_path``, built if it is not there.  None under
    SEQALIGN_TPU_NATIVE=0, when ``src`` is missing or when it cannot be
    built or loaded (no compiler): the caller then takes its NumPy or
    Python path."""
    if os.environ.get("SEQALIGN_TPU_NATIVE", "1") == "0" or not src.exists():
        return None
    so = library_path(src.stem, src.read_bytes(),
                      isa="-march=native" in flags)
    try:
        build(so, ["gcc", "-O3", "-shared", "-fPIC", *flags, src])
        return ctypes.CDLL(str(so))
    except (OSError, RuntimeError):
        return None
