"""Long DNA on the port's long route (linear-v1) through the library
align() on the CPU, against the benchmark's plain reference
(portbench/reference/dp.py) under EDNAFULL: sequences on both sides of
W_MAX (4096) and one of exactly 4096, and the launch counts a traced run
keeps.  A file of its own: it takes some 20 s of the CPU's plain kernels,
so under pytest-xdist's --dist loadfile it gets a worker to itself.
"""

import numpy as np
import pytest
import torch

import sequencealigner_tpu_torch as port_pkg
from portbench.reference import dp, matrix
from sequencealigner_tpu_torch import engine, matrices, trace
from sequencealigner_tpu_torch.ops import geometry

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

TABLE = "portbench/data/dnafull.txt"


def _genomes():
    """Five DNA sequences of 4,090-4,300 bases drawn from a seed and one of
    exactly 4,096, at GC 40%."""
    rng = np.random.default_rng(16)
    lengths = [*rng.integers(4090, 4301, 5), geometry.W_MAX]
    return [bytes(rng.choice(np.frombuffer(b"ATGC", np.uint8), int(n),
                             p=[0.3, 0.3, 0.2, 0.2])).decode()
            for n in lengths]


def test_long_dna_takes_linear_v1():
    seqs = _genomes()
    lengths = [len(s) for s in seqs]
    assert min(lengths) <= geometry.W_MAX < max(lengths)
    assert geometry.W_MAX in lengths
    eng = engine.Engine("ga", matrices.get("dnafull").matrix, (0, -16, -4),
                        device="cpu")
    assert eng.schedule_token(lengths).startswith("linear-v1")


# EMBOSS stretcher's nucleic defaults, open 16 and extend 4; and an extend
# dearer than the open, where GA's border slope max(open, extend) of the
# negated penalties (ROADMAP C4) is the open's and not the extend's.
@pytest.mark.parametrize("opn,ext", [(16, 4), (2, 6)],
                         ids=["stretcher-16-4", "extend-over-open-2-6"])
def test_long_dna_equals_the_reference(monkeypatch, opn, ext):
    """The full matrix equals the reference's scores both ways round, the
    diagonal is 0, and the traced run's launch counts hold every true cell
    in align_pairs' launches, none in align_tiles'."""
    monkeypatch.setenv("SEQALIGN_TPU_DEBUG_PHASES", "1")
    seqs = _genomes()
    before = trace.runs()[-1:]
    m = np.asarray(port_pkg.align(seqs, algo="ga", matrix="dnafull",
                                  open=opn, extend=ext, device="cpu"))
    run = trace.runs()[-1]
    assert trace.runs()[-1:] != before

    _, sub, lut = matrix.load(TABLE)
    data = np.frombuffer("".join(seqs).encode(), np.uint8)
    lengths = np.array([len(s) for s in seqs], np.int64)
    offsets = np.r_[0, np.cumsum(lengths)]
    i, j = np.triu_indices(len(seqs), 1)
    want = dp.scores("ga", lut[data], offsets, i, j, sub, (0, -opn, -ext),
                     budget=1 << 24)
    np.testing.assert_array_equal(m[i, j], want)
    np.testing.assert_array_equal(m[j, i], want)
    assert not np.diagonal(m).any()

    assert run.top.attrs["schedule"] == "linear-v1"
    launches = run.dp_launches
    assert launches and {x.kernel for x in launches} == {"align_pairs"}
    assert sum(x.cells for x in launches) == int((lengths[i] * lengths[j])
                                                 .sum())
    assert sum(x.pairs for x in launches) == len(i)
