"""Sequences longer than W_MAX (4096) through the port's library align()
and its CLI on the CPU.  A file of its own: the test takes minutes on the
CPU's plain kernels, so under pytest-xdist's --dist loadfile it gets a
worker to itself.
"""

import torch

import sequencealigner_tpu_torch as port_pkg
from sequencealigner_tpu_torch import cli as port_cli

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)


def test_sequences_over_4096_through_align_and_cli(tmp_path):
    """Real bucket edges beyond 4096, through align() and the CLI with -C:
    NW of A*4100 against A*4300 scores 4 * 4100 + 200 * gap (BLOSUM62
    A/A = 4, gap -4)."""
    a, b = "A" * 4100, "A" * 4300
    m = port_pkg.align([a, b], algo="nw", gap=4, device="cpu")
    assert m[0, 1] == m[1, 0] == 4 * 4100 + 200 * -4
    fa = tmp_path / "long.fasta"
    fa.write_text(f">a\n{a}\n>b\n{b}\n")
    out = tmp_path / "long.h5"
    rc = port_cli.run(["-i", str(fa), "-o", str(out), "-m", "blosum62", "-a",
                       "nw", "-p", "4", "-C", "-F", "-Q", "-P"])
    assert rc == 0
    import h5py

    with h5py.File(out) as f:
        assert f["/similarity_matrix"][0, 1] == 4 * 4100 + 200 * -4
