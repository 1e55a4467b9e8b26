"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench.core import harness
from portbench.tests.conftest import BENCH, ROOT

JAX = ("jax", "jaxlib", "flax", "sequencealigner_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in JAX, (f, mod)
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("sequencealigner_tpu_torch", "portbench"), (
                f, mod)


def _probe(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_a_run_loads_no_jax_and_the_reference_no_program(tmp_path):
    tops = _probe(
        "import sys, time, pathlib;"
        "sys.path.insert(0, 'portbench/tests');"
        "import conftest as c;"
        f"b = c.tiny_bench(pathlib.Path({str(tmp_path)!r}));"
        "r, bad, _ = c.run_cpu(b, 'tiny.cell');"
        "assert r['correct'] and not bad;"
        "print(*sorted({m.split('.')[0] for m in sys.modules}))")
    assert "sequencealigner_tpu_torch" in tops
    assert not set(tops) & set(JAX)
    tops = _probe(
        "import sys; import portbench.reference.dp, "
        "portbench.reference.matrix;"
        "print(*sorted({m.split('.')[0] for m in sys.modules}))")
    assert "torch" in tops
    assert "sequencealigner_tpu_torch" not in tops and not set(tops) & set(JAX)


LOADS_JAX = '''"""A per-layer metric of the test that loads JAX."""
import jax


def read(r):
    return 1.0
'''


def test_a_module_loaded_after_the_window_stops_the_result(tmp_path):
    """A per-layer reader that loads JAX (here a stub of it) runs after the
    window has closed; the run then prints no result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    code = (
        "import io, json, pathlib, sys;"
        "sys.path.insert(0, 'portbench/tests');"
        "import conftest as c;"
        "from portbench.core import harness;"
        f"t = pathlib.Path({str(tmp_path)!r});"
        "b = c.tiny_bench(t / 'b', extra_files={'metrics/test.jax.py': "
        f"{LOADS_JAX!r}}});"
        "s = json.loads((t / 'b' / 'BENCHMARK.json').read_text());"
        "s['per_layer'].append({'name': 'test.jax', 'unit': '1', "
        "'better': 'lower', 'source': 'program_counter', 'layer': 'test', "
        "'moves': 'gcups'});"
        "(t / 'b' / 'BENCHMARK.json').write_text(json.dumps(s));"
        "b = type(b)(b.root, b.dir);"
        "r, bad, logs = c.run_cpu(b, 'tiny.cell', trace=True);"
        "out = io.StringIO();"
        "rc = harness.emit(r, bad, out, logs.append);"
        "print(json.dumps([r['correct'], 'test.jax' in r['metrics'], bad, "
        "rc, out.getvalue(), logs[-1]]))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{stub}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    correct, measured, bad, rc, out, last = json.loads(r.stdout)
    # Sound and measured, clean when the window closed, and still refused.
    assert correct and measured and bad == []
    assert rc != 0 and out == ""
    assert "['jax']" in last


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sequencealigner_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    for name in JAX:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "sequencealigner_tpu.engine", sys)
    assert harness.forbidden_modules() == ["jax", "sequencealigner_tpu"]


def test_run_without_the_program_or_a_card_prints_no_result(tmp_path):
    """From a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "swissprot-ga.tiles", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
