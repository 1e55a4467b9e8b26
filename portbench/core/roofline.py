"""The least device time of the DP kernels' work, and the chip's peak.

Frozen copy of ``bound_ms`` and its constants from the port's
``sequencealigner_tpu_torch/tools/profile_main.py``, kept here so that no
later change to the program moves the yardstick.

A DP cell needs at least NW 3, GA 6, SW 6.5 instructions: NW the diagonal
add and two add-max; GA three adds, two add-max and one three-way max; SW
GA's with the zero floor folded into the max and the running best taken by
one three-way max per two cells.  Of those, the DPX and min/max ones (NW 2,
GA 3, SW 3.5) run on the ALU pipe at 64 a clock per SM, the adds on the FMA
pipe beside it, and an SM issues 128 a clock.  A cell takes the largest of
the three clock counts, over 132 SMs at 1.98 GHz (H100 SXM): GA's 3/64 of a
clock per cell and SM is 5,575 GCUPS for the card.  The bound counts the
algorithm's true cells (sum of l1 * l2 over the pairs), not what an
implementation pads them to.
"""

OPS_PER_CELL = {"nw": 3, "ga": 6, "sw": 6.5}
ALU_OPS_PER_CELL = {"nw": 2, "ga": 3, "sw": 3.5}
ISSUE, PIPE = 128, 64
SMS, CLOCK_HZ = 132, 1.98e9


def bound_ms(cells: int, algo: str) -> float:
    """Least device milliseconds for ``cells`` true DP cells of ``algo``."""
    ops, alu = OPS_PER_CELL[algo], ALU_OPS_PER_CELL[algo]
    clocks = max(ops / ISSUE, alu / PIPE, (ops - alu) / PIPE)
    return cells * clocks / (SMS * CLOCK_HZ) * 1e3


def peak_gcups(algo: str) -> float:
    """The card's bound as a rate: true cells a second, in billions."""
    return 1e9 / bound_ms(10**9, algo) * 1e3 / 1e9


#: DP kernels of the program, by the symbol their device names hold.
DP_KERNELS = ("tiles_kernel", "pairs_kernel", "grid_kernel")
