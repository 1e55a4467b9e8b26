"""The port's measurement tools on the CPU: they refuse to run without a card,
and the parts that need none (the SASS reader of dpx_rate, the bound of
profile_main) hold."""

import subprocess

import pytest
import torch

from sequencealigner_tpu_torch.tools import dpx_rate, profile_main

# One intra-op thread: the test workers share the CPU's cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("tool,argv", [
    (profile_main, ["--set", "main"]),
    (profile_main, ["--set", "wide"]),
    (profile_main, ["--set", "long"]),
    (dpx_rate, []),
])
def test_tools_exit_2_without_a_card(tool, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_111rate_kernelILi4EEEvPKiiPiPx
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   IMAD.IADD R5, R5, 0x1, R6 ;
        /*0110*/                   IADD3 R7, R7, R2, RZ ;
        /*0120*/              @!P0 VIADDMNMX R5, R5, R3, R6, !PT ;
        /*0130*/                   VIMNMX3 R8, R5, R7, R9, !PT ;
        /*0140*/                   BRA 0x100 ;
                Function : _ZN12_GLOBAL__N_111rate_kernelILi0EEEvPKiiPiPx
        /*0100*/                   IADD3 R7, R7, R2, RZ ;
        /*0110*/                   IADD3 R8, R8, R7, RZ ;
"""


def test_dpx_rate_reads_opcodes_per_kernel(monkeypatch, tmp_path):
    """The SASS reader counts each kernel's opcodes with their modifiers,
    predicated ones too, and skips what it does not list."""
    tool = tmp_path / "cuobjdump"
    tool.write_text("")
    monkeypatch.setattr(dpx_rate.shutil, "which", lambda name: str(tool))
    monkeypatch.setattr(
        dpx_rate.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=SASS))
    ops = dpx_rate.sass_opcodes(tmp_path / "lib.so")
    assert ops["ga"] == {"IMAD.IADD": 1, "IADD3": 1, "VIADDMNMX": 1,
                         "VIMNMX3": 1}
    assert ops["iadd"] == {"IADD3": 2}


@pytest.mark.parametrize("algo,per_clock", [
    ("nw", 32), ("ga", 64 / 3), ("sw", 64 / 3.5)])
def test_bound_is_the_busiest_pipe_or_issue(algo, per_clock):
    """bound_ms is the cells at the fewest SM clocks a cell needs: NW and
    SW by their DPX instructions on the 64-a-clock ALU pipe, GA as much by
    that pipe as by issue (6 instructions at 128 a clock)."""
    cells = 10**12
    assert profile_main.bound_ms(cells, algo) == pytest.approx(
        cells / per_clock / (132 * 1.98e9) * 1e3)
