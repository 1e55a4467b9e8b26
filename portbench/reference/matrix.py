"""The substitution matrix and residue table, read from the frozen text
copies under data/ (NCBI's layout)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load(path: Path) -> tuple[str, np.ndarray, np.ndarray]:
    """(alphabet, (A, A) int32 scores, (128,) int32 LUT) of a matrix file:
    the header row names the residues, each later row starts with its
    residue; the LUT maps a residue's ASCII code to its row, -1 elsewhere."""
    rows = [ln.split() for ln in Path(path).read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]
    alphabet = "".join(rows[0])
    if len(set(alphabet)) != len(alphabet):
        raise ValueError(f"{path}: a residue is named twice")
    body = rows[1:]
    if [r[0] for r in body] != list(alphabet):
        raise ValueError(f"{path}: rows do not follow the header")
    sub = np.array([[int(v) for v in r[1:]] for r in body], np.int32)
    if sub.shape != (len(alphabet), len(alphabet)):
        raise ValueError(f"{path}: not a square matrix")
    lut = np.full(128, -1, np.int32)
    for k, ch in enumerate(alphabet):
        lut[ord(ch)] = k
    return alphabet, sub, lut
