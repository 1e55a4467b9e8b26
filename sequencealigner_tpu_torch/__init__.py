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
    filter_threshold: float = 0.0,
    device="cuda",
    progress: bool = False,
):
    """Library entry point: all-vs-all similarity matrix for ``sequences``.

    sequences: iterable of str/bytes.  algo: "nw" (linear gap, uses ``gap``)
    | "ga" | "sw" (affine, use ``open``/``extend``).  Penalties are positive
    magnitudes, negated internally like the CLI.  device: what Engine takes
    (engine.resolve_devices): "cuda", every local CUDA device (the
    kernels); "cuda:K" one of them; "cpu" (their plain PyTorch versions);
    or a list of such devices.  The filter runs on the first of them.
    Returns an (n, n) int32 NumPy array (0 on the diagonal); with
    filter_threshold > 0 returns (matrix, kept_indices) instead, the matrix
    over the survivors of the similarity filter (filter.filter_sequences).

    >>> import sequencealigner_tpu_torch as sa
    >>> m = sa.align(["ARNDCQ", "ARNDCC"], algo="nw", gap=4, device="cpu")
    """
    import numpy as np

    from . import filter as _filter
    from . import matrices as _matrices
    from .engine import Engine, resolve_devices
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
    kept = None
    if filter_threshold > 0.0:
        ss, _dropped = _filter.filter_sequences(
            ss, filter_threshold, progress=progress,
            device=resolve_devices(device)[0],
        )
        kept = ss.kept
    if algo == "nw":
        gaps = (-abs(int(gap)), 0, 0)
    else:
        gaps = (0, -abs(int(open)), -abs(int(extend)))
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng = Engine(algo, m.matrix, gaps, device=device)
    eng.align_all(ss, store, progress=progress)
    out = np.asarray(store.matrix).reshape(ss.num, ss.num)
    if filter_threshold > 0.0:
        return out, kept
    return out
