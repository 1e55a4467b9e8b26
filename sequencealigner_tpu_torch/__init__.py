"""seqalign-torch: all-vs-all pairwise sequence alignment in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``sequencealigner_tpu`` (the JAX reference package, which it
never imports).  Scores are bit-identical to the reference's.
"""


def align(
    sequences,
    *,
    algo: str = "ga",
    matrix: str = "blosum62",
    gap: int = 4,
    open: int = 10,
    extend: int = 1,
    device: str = "cuda",
    progress: bool = False,
):
    """Library entry point: all-vs-all similarity matrix for ``sequences``.

    sequences: iterable of str/bytes.  algo: "nw" (linear gap, uses ``gap``)
    | "ga" | "sw" (affine, use ``open``/``extend``).  Penalties are positive
    magnitudes, negated internally like the CLI.  device: "cuda" (the
    kernels) or "cpu" (their plain PyTorch versions).  Returns an (n, n)
    int32 NumPy array (0 on the diagonal).

    >>> import sequencealigner_tpu_torch as sa
    >>> m = sa.align(["ARNDCQ", "ARNDCC"], algo="nw", gap=4, device="cpu")
    """
    import numpy as np

    from . import matrices as _matrices
    from .engine import Engine
    from .io.input import SequenceSet
    from .io.output import OutputStore

    m = _matrices.get(matrix)
    seqs = [
        np.frombuffer(s.upper().encode() if isinstance(s, str) else bytes(s).upper(),
                      np.uint8)
        for s in sequences
    ]
    # A char outside the matrix alphabet maps to LUT -1, which would wrap
    # into the substitution matrix's last row: reject it like the parsers.
    lut = np.asarray(m.lut)
    for sno, s in enumerate(seqs):
        bad = lut[s] < 0
        if bad.any():
            ch = chr(int(s[np.argmax(bad)]))
            raise ValueError(
                f"sequence {sno + 1}: invalid character {ch!r} for matrix "
                f"{matrix!r}"
            )
    ss = SequenceSet.from_list(seqs, m.lut)
    if algo == "nw":
        gaps = (-abs(int(gap)), 0, 0)
    else:
        gaps = (0, -abs(int(open)), -abs(int(extend)))
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng = Engine(algo, m.matrix, gaps, device=device)
    eng.align_all(ss, store, progress=progress)
    return np.asarray(store.matrix).reshape(ss.num, ss.num)
