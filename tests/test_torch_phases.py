"""SEQALIGN_TPU_DEBUG_PHASES in the port's engine: with the variable set,
``align_all`` prints one ``[phases]`` line whose keys are the JAX engine's
for the same store mode, and its scores do not change; without it, no
line."""

import contextlib
import functools
import io
import re
from unittest import mock

import numpy as np
import pytest
import torch

from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu.io.output import OutputStore as RefOutputStore
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.io.input import SequenceSet
from sequencealigner_tpu_torch.io.output import OutputStore

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)
LINE = re.compile(r"\[phases\] wall=(\d+\.\d)ms((?:  [\w.+]+=-?\d+\.\dms)+)")


def _seqs():
    """64 short and 64 longer proteins: two buckets (Schedule.build merges
    a bucket of fewer than 64 rows into its neighbour)."""
    rng = np.random.default_rng(8)
    return [rng.choice(AA, int(n))
            for n in np.r_[rng.integers(4, 13, 64), rng.integers(40, 61, 64)]]


def _run(eng, ss, store, phases: bool):
    """(stats, stdout) of one align_all, with or without the variable."""
    env = {"SEQALIGN_TPU_DEBUG_PHASES": "1"} if phases else {}
    out = io.StringIO()
    with mock.patch.dict("os.environ", env), contextlib.redirect_stdout(out):
        stats = eng.align_all(ss, store, progress=False)
    return stats, out.getvalue()


def _phases(out: str):
    """(wall ms, {phase: ms}) of the one [phases] line in ``out``."""
    lines = [ln for ln in out.splitlines() if ln.startswith("[phases]")]
    assert len(lines) == 1, out
    m = LINE.fullmatch(lines[0])
    assert m, lines[0]
    parts = dict(p.split("=") for p in m.group(2).split())
    return float(m.group(1)), {k: float(v[:-2]) for k, v in parts.items()}


@functools.lru_cache(maxsize=None)
def _reference(full: bool):
    """The JAX engine's phase keys (on a one-device CPU mesh) and its
    matrix (None without a store)."""
    seqs = _seqs()
    n = len(seqs)
    eng = ref_engine.Engine("ga", M.matrix, GAPS,
                            mesh=ref_engine.make_mesh("cpu", 1))
    store = RefOutputStore(n, triangular=False, spill=False) if full else None
    _, out = _run(eng, RefSequenceSet.from_list(seqs, M.lut), store, True)
    mat = np.asarray(store.matrix).reshape(n, n).copy() if full else None
    return frozenset(_phases(out)[1]), mat


@pytest.mark.parametrize("full", [True, False], ids=["store", "no-store"])
@pytest.mark.parametrize("outer", ["1", "0"], ids=["tiles-v2", "linear-v1"])
def test_phase_line_has_the_reference_keys(monkeypatch, outer, full):
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    monkeypatch.delenv("SEQALIGN_TPU_DEBUG_PHASES", raising=False)
    seqs = _seqs()
    n = len(seqs)
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = port_engine.Engine("ga", M.matrix, GAPS, device="cpu")
    kind = "tiles-v2" if outer == "1" else "linear-v1"
    assert eng.schedule_token(ss.lengths).startswith(kind)
    assert len(port_engine.Schedule.build(ss.lengths).buckets) == 2

    def store():
        return OutputStore(n, triangular=False, spill=False) if full else None

    plain_store, timed_store = store(), store()
    plain, out = _run(eng, ss, plain_store, False)
    assert "[phases]" not in out
    timed, out = _run(eng, ss, timed_store, True)
    wall, phases = _phases(out)

    ref_keys, ref_mat = _reference(full)
    assert set(phases) == ref_keys
    assert len(phases) == (4 if full else 3)
    assert wall >= 0 and min(phases.values()) >= 0
    assert (timed.pairs, timed.cells) == (plain.pairs, plain.cells)
    if full:
        mat = np.asarray(timed_store.matrix).reshape(n, n)
        np.testing.assert_array_equal(
            mat, np.asarray(plain_store.matrix).reshape(n, n))
        np.testing.assert_array_equal(mat, ref_mat)
