"""Multi-host ownership against the JAX engine, on the CPU: under
``partition=(h, 2)`` each host of the port scores exactly the pairs, with
the same scores, that the JAX engine's host h scores, under both
schedules.  The JAX engine runs its tile and per-pair kernels in interpret
mode on ONE device: its block widths scale with its device count (ROADMAP
C5), and one device is the port's block stream.  A file of its own: the
Pallas interpreter takes tens of seconds a run."""

import numpy as np
import pytest
import torch

from sequencealigner_tpu import engine as ref_engine
from sequencealigner_tpu import matrices as ref_matrices
from sequencealigner_tpu.io.input import SequenceSet as RefSequenceSet
from sequencealigner_tpu_torch import engine as port_engine
from sequencealigner_tpu_torch.io.input import SequenceSet

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)

M = ref_matrices.get("blosum62")
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAPS = (0, -10, -1)


def _two_bucket_seqs():
    """The 210-sequence two-bucket set of tests/test_torch_engine.py."""
    rng = np.random.default_rng(21)
    return [rng.choice(AA, int(n))
            for n in np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]]


def _owned(eng, ss, host):
    """(pair ids i * n + j, scores) host ``host`` of two scores, in id
    order, read from what it hands its merger."""
    calls = []
    eng.align_all(ss, None, progress=False, partition=(host, 2),
                  merger=lambda i, j, s: calls.append((i, j, s)) or (i, j, s))
    ids = np.concatenate([np.asarray(i, np.int64) * ss.num + np.asarray(j)
                          for i, j, _ in calls])
    scores = np.concatenate([np.asarray(s, np.int32) for _, _, s in calls])
    order = np.argsort(ids)
    return ids[order], scores[order]


@pytest.mark.parametrize("outer", ["1", "0"])
def test_hosts_own_the_reference_pairs(monkeypatch, outer):
    monkeypatch.setenv("SEQALIGN_TPU_OUTER", outer)
    for mod in (ref_engine, port_engine):
        monkeypatch.setattr(mod, "FLUSH_PAIRS", 4096)
    seqs = _two_bucket_seqs()
    port = port_engine.Engine("ga", M.matrix, GAPS, device="cpu")
    ref = ref_engine.Engine("ga", M.matrix, GAPS,
                            mesh=ref_engine.make_mesh("cpu", 1),
                            use_pallas=True, pallas_interpret=True)
    ss = SequenceSet.from_list(seqs, M.lut)
    rss = RefSequenceSet.from_list(seqs, M.lut)
    assert port.schedule_token(ss.lengths) == ref.schedule_token(rss.lengths)
    seen = 0
    for host in (0, 1):
        got_ids, got = _owned(port, ss, host)
        want_ids, want = _owned(ref, rss, host)
        assert len(got_ids) > 0
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got, want)
        seen += len(got_ids)
    assert seen == len(seqs) * (len(seqs) - 1) // 2
