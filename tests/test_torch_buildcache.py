"""The kernel library's build directory (``cuda_dp.cache_dir``) and
``cuda_dp.load_library`` end to end, with a stand-in for nvcc: a script
that builds, with gcc, a C stub exporting the symbols the loader binds."""

import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from sequencealigner_tpu_torch import ui
from sequencealigner_tpu_torch.ops import cuda_dp

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

PKG = Path(cuda_dp.__file__).resolve().parents[1]

STUB = "\n".join(
    f"int align_dp_{name}(void) {{ return 0; }}"
    for name in ("tiles", "tiles_resident", "pairs", "pairs_resident",
                 "grid", "grid_resident")
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
    monkeypatch.setattr(cuda_dp, "_lib", None)
    monkeypatch.setattr(cuda_dp, "_private", None)
    monkeypatch.setattr(cuda_dp, "build_seconds", 0.0)
    monkeypatch.setattr(cuda_dp, "build_log", "")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setattr(ui.state, "quiet", False)


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
    assert cuda_dp.cache_dir() == want and want.is_dir()


def test_cache_dir_takes_the_variable(monkeypatch, tmp_path, fresh):
    want = tmp_path / "a" / "b"
    monkeypatch.setenv("SEQALIGN_TPU_CACHE", str(want))
    assert cuda_dp.cache_dir() == want and want.is_dir()


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
    assert tmp.parent == cuda_dp._private and tmp.parent.parent == tmp_path
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
