"""Uniform sequence lengths: whole residues from ``min`` to ``max`` of the
configuration, both included, within [lo, hi]."""

import numpy as np


def draw(rng: np.random.Generator, n: int, params: dict, lo: int,
         hi: int) -> np.ndarray:
    a, b = max(params["min"], lo), min(params["max"], hi)
    if a > b:
        raise ValueError(f"no length in [{a}, {b}]")
    return rng.integers(a, b + 1, n, dtype=np.int64)
