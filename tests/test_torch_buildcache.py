"""The port's build directory (``buildcache.cache_dir``) and
``cuda_dp.load_library`` end to end, with a stand-in for nvcc: a script
that builds, with gcc, a C stub exporting the symbols the loader binds."""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from sequencealigner_tpu_torch import buildcache, ui
from sequencealigner_tpu_torch.ops import cuda_dp

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

PKG = Path(cuda_dp.__file__).resolve().parents[1]

STUB = "\n".join(
    f"int align_dp_{name}(void) {{ return 0; }}"
    for name in ("tiles", "tiles_resident", "tiles16", "tiles16_resident",
                 "pairs", "pairs_resident", "grid", "grid_resident")
) + '\nconst char *align_dp_error_string(int e) { return "stub"; }\n'

FAKE_NVCC = f"""#!{sys.executable}
import os, subprocess, sys, tempfile
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(out + "\\n")
with tempfile.TemporaryDirectory() as td:
    src = os.path.join(td, "stub.c")
    with open(src, "w") as f:
        f.write({STUB!r})
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
print("ptxas info    : Used 1 registers", file=sys.stderr)
"""

# Runs in a fresh interpreter: loads the library, prints where from.
LOAD = textwrap.dedent("""
    from sequencealigner_tpu_torch.ops import cuda_dp
    lib = cuda_dp.load_library()
    print(cuda_dp.__file__)
    print(lib._name)
    print(cuda_dp.build_seconds)
""")


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """The stand-in nvcc, through NVCC; returns the file that lists the
    output name of each of its builds."""
    exe = tmp_path / "fake_nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.touch()
    monkeypatch.setenv("NVCC", str(exe))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return log


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """No library loaded in this process, and a private directory (if one
    is made) under tmp_path."""
    monkeypatch.setattr(buildcache, "_private", None)
    monkeypatch.setattr(buildcache, "_unusable", set())
    monkeypatch.setattr(cuda_dp, "build_seconds", 0.0)
    monkeypatch.setattr(cuda_dp, "build_log", "")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setattr(ui.state, "quiet", False)
    cuda_dp.load_library.cache_clear()
    yield
    cuda_dp.load_library.cache_clear()


def _load_in_subprocess(env: dict, pythonpath: Path = PKG.parent, cwd=None):
    """(cuda_dp file, library path, build seconds) of a fresh process."""
    r = subprocess.run(
        [sys.executable, "-c", LOAD], capture_output=True, text=True,
        env={**os.environ, **env, "PYTHONPATH": str(pythonpath),
             "PYTHONDONTWRITEBYTECODE": "1"},
        cwd=cwd or PKG.parent, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    mod, so, secs = r.stdout.split("\n")[-4:-1]
    return Path(mod), Path(so), float(secs)


def _tree(root: Path) -> set:
    return {p.relative_to(root) for p in root.rglob("*")
            if "__pycache__" not in p.parts}


def test_cache_dir_defaults_to_the_user_cache(monkeypatch, tmp_path, fresh):
    monkeypatch.delenv("SEQALIGN_TPU_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    want = tmp_path / ".cache" / "sequencealigner-tpu"
    assert buildcache.cache_dir() == want and want.is_dir()


def test_cache_dir_takes_the_variable(monkeypatch, tmp_path, fresh):
    want = tmp_path / "a" / "b"
    monkeypatch.setenv("SEQALIGN_TPU_CACHE", str(want))
    assert buildcache.cache_dir() == want and want.is_dir()


@pytest.mark.parametrize("where", ["under-a-file", "a-file"])
def test_unusable_cache_warns_once_and_builds_privately(
        monkeypatch, tmp_path, capsys, fresh, nvcc, where):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    bad = blocker / "cache" if where == "under-a-file" else blocker
    monkeypatch.setenv("SEQALIGN_TPU_CACHE", str(bad))
    cuda_dp.load_library()
    out = capsys.readouterr().out.splitlines()
    warned = [ln for ln in out if str(bad) in ln]
    assert len(warned) == 1 and "private directory" in warned[0], out
    tmp = Path(nvcc.read_text().split()[0])
    assert tmp.parent == buildcache._private and tmp.parent.parent == tmp_path
    assert cuda_dp.build_seconds > 0 and blocker.read_text() == ""


@pytest.mark.parametrize("value", ["0", ""])
def test_no_cache_builds_privately_and_leaves_nothing(tmp_path, nvcc, value):
    work = tmp_path / "tmp"
    work.mkdir()
    _, so, secs = _load_in_subprocess(
        {"SEQALIGN_TPU_CACHE": value, "TMPDIR": str(work)})
    assert secs > 0 and so.parent.parent == work
    assert nvcc.read_text().count("\n") == 1
    assert not so.parent.exists() and not any(work.iterdir())


def test_build_once_then_load_from_the_cache(monkeypatch, tmp_path, fresh,
                                             nvcc):
    cache = tmp_path / "cache"
    monkeypatch.setenv("SEQALIGN_TPU_CACHE", str(cache))
    before = _tree(PKG)
    lib = cuda_dp.load_library()
    so = Path(lib._name)
    assert cuda_dp.build_seconds > 0 and "registers" in cuda_dp.build_log
    assert so.parent == cache and so.name.startswith("libalign_dp-")
    assert sorted(p.name for p in cache.iterdir()) == [so.name]
    # The output went to a name of this host and process, renamed into place.
    (tmp,) = nvcc.read_text().split()
    assert tmp == f"{so}.{socket.gethostname()}.{os.getpid()}.tmp"
    assert cuda_dp.load_library() is lib
    # A second process loads what the first built.
    _, so2, secs = _load_in_subprocess({"SEQALIGN_TPU_CACHE": str(cache)})
    assert so2 == so and secs == 0.0
    assert nvcc.read_text().split() == [tmp]
    assert _tree(PKG) == before


def test_read_only_package_builds(tmp_path, nvcc):
    root = tmp_path / "ro"
    copy = root / PKG.name
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "_build"))
    paths = [copy, *copy.rglob("*")]
    for p in paths:
        p.chmod(0o555 if p.is_dir() else 0o444)
    before = _tree(copy)
    try:
        cache = tmp_path / "cache"
        mod, so, secs = _load_in_subprocess(
            {"SEQALIGN_TPU_CACHE": str(cache)}, pythonpath=root, cwd=tmp_path)
    finally:
        for p in paths:
            p.chmod(0o755 if p.is_dir() else 0o644)
    assert mod.is_relative_to(copy)
    assert secs > 0 and so.parent == cache and so.exists()
    assert _tree(copy) == before


# Runs in a fresh interpreter: loads the host libraries (and with "cuda"
# the kernel library) and prints, as JSON, each one's file or null.
LOAD_ALL = textwrap.dedent("""
    import json, sys
    from sequencealigner_tpu_torch.io import direct_fill, native
    libs = {"fastparse": native.get(), "hostops": native.hostops(),
            "direct_fill": direct_fill._library()}
    if "cuda" in sys.argv:
        from sequencealigner_tpu_torch.ops import cuda_dp
        libs["align_dp"] = cuda_dp.load_library()
    print(json.dumps({k: v and v._name for k, v in libs.items()}))
""")

# As LOAD_ALL, but first marks itself ready and waits for the go file.
RACE = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    go = Path(sys.argv[1])
    (go.parent / f"ready.{os.getpid()}").touch()
    while not go.exists():
        time.sleep(0.001)
""") + LOAD_ALL


def _env(**env) -> dict:
    """This environment with the package on the path, no build-cache or
    native-library setting of its own, and ``env``."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("SEQALIGN_TPU_CACHE", "SEQALIGN_TPU_NATIVE")}
    return {**base, "PYTHONPATH": str(PKG.parent),
            "PYTHONDONTWRITEBYTECODE": "1", **env}


def _libraries(env: dict, *argv, cwd=None) -> dict:
    """LOAD_ALL's libraries in a fresh process."""
    r = subprocess.run([sys.executable, "-c", LOAD_ALL, *argv],
                       capture_output=True, text=True, env=_env(**env),
                       cwd=cwd or PKG.parent, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.splitlines()[-1])


def test_processes_building_at_once_all_load_the_host_libraries(tmp_path):
    """Six processes that load the host libraries at the same moment into
    one empty cache each get every one: a process that loses a build race
    loads the winner's library instead of running without it."""
    cache, sync = tmp_path / "cache", tmp_path / "sync"
    sync.mkdir()
    go = sync / "go"
    env = _env(SEQALIGN_TPU_CACHE=str(cache))
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(go)], env=env,
                              cwd=PKG.parent, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    try:
        deadline = time.monotonic() + 120
        while (len(list(sync.glob("ready.*"))) < len(procs)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    loaded = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        loaded.append(json.loads(out.splitlines()[-1]))
    assert all(None not in libs.values() for libs in loaded), loaded
    assert all(libs == loaded[0] for libs in loaded)
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        Path(f).name for f in loaded[0].values())


@pytest.mark.parametrize("value", ["0", ""])
def test_no_cache_loads_host_libraries_and_leaves_nothing(tmp_path, value):
    """With SEQALIGN_TPU_CACHE 0 or empty the host libraries are built into
    the process's private directory, which is gone at its exit, and
    nothing is made in the working directory."""
    work, tmp = tmp_path / "work", tmp_path / "tmp"
    work.mkdir()
    tmp.mkdir()
    libs = _libraries({"SEQALIGN_TPU_CACHE": value, "TMPDIR": str(tmp)},
                      cwd=work)
    dirs = {Path(f).parent for f in libs.values()}
    assert None not in libs.values() and len(dirs) == 1
    assert dirs.pop().parent == tmp
    assert not any(work.iterdir()) and not any(tmp.iterdir())


@pytest.mark.parametrize("where", ["a-path", "unset", "0"])
def test_every_library_resolves_to_one_cache_dir(tmp_path, nvcc, where):
    """The host libraries and the kernel library land in one directory,
    ``buildcache.cache_dir()``'s, under the names the JAX package's loader
    gives the host libraries, so that a cache either package warmed is
    loaded, not rebuilt."""
    from sequencealigner_tpu.io import native as ref_native

    env = {"HOME": str(tmp_path / "home"), "TMPDIR": str(tmp_path)}
    want = {"a-path": str(tmp_path / "cache"),
            "unset": str(tmp_path / "home" / ".cache" / "sequencealigner-tpu"),
            "0": None}[where]
    if where != "unset":
        env["SEQALIGN_TPU_CACHE"] = want or where
    libs = _libraries(env, "cuda")
    dirs = {str(Path(f).parent) for f in libs.values()}
    assert None not in libs.values() and len(dirs) == 1
    if want is not None:
        assert dirs == {want}
    isa = ref_native._host_isa_tag()
    host, csrc = PKG.parent / "native", PKG / "csrc"

    def lib(stem: str, data: bytes, tag: str = "") -> str:
        return f"lib{stem}-{hashlib.sha256(data).hexdigest()[:16]}{tag}.so"

    def src(path: Path) -> bytes:
        return path.read_bytes()

    kernels = b"".join(map(src, sorted(csrc.glob("*.cu"))))
    assert {k: Path(f).name for k, f in libs.items()} == {
        "fastparse": lib("fastparse", src(host / "fastparse.c")),
        "hostops": lib("hostops", src(host / "hostops.c"), f"-{isa}"),
        "direct_fill": lib("direct_fill", src(csrc / "direct_fill.c"),
                           f"-{isa}"),
        "align_dp": lib("align_dp", cuda_dp.ARCH.encode() + kernels)}
