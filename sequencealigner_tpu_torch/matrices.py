# Copy of sequencealigner_tpu/matrices.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Substitution-matrix registry.

Feature parity with the reference's matrix subsystem
(reference src/bio/matrices.c:12-77 and generated/matrices.h): 65 amino
(blosum*/pam*) + 2 nucleotide (dnafull, nuc44) matrices stored as 24x24 int32
frames, two 128-entry char->index LUTs (amino alphabet ARNDCQEGHILKMFPSTWYVBZX*,
nucleotide ATGCSWRYKMBVHDN*), case-insensitive selection by name, and grouped
listing.  Scores are Parasail's matrices bit-for-bit, like the reference
(generated by reference script/generate_matrices.py).
"""

from __future__ import annotations

import dataclasses
import importlib.resources
from functools import lru_cache

import numpy as np

SUB_MAT_DIM = 24
SEQ_LUT_SIZE = 128
#: Sentinel for impossible DP states, s32 min / 2 (reference src/bio/align.h:19)
SCORE_MIN = -(2**31) // 2


@dataclasses.dataclass(frozen=True)
class SubstitutionMatrix:
    name: str
    matrix: np.ndarray  # (24, 24) int32
    lut: np.ndarray  # (128,) int32, char -> index or -1
    is_amino: bool

    @property
    def alphabet(self) -> str:
        order = sorted((idx, chr(c)) for c in range(128) if (idx := int(self.lut[c])) >= 0)
        return "".join(ch for _, ch in order)


@lru_cache(maxsize=1)
def _load():
    ref = importlib.resources.files("sequencealigner_tpu_torch") / "_matrix_data.npz"
    with importlib.resources.as_file(ref) as path:
        data = np.load(path, allow_pickle=False)
        return (
            [str(n) for n in data["names"]],
            np.asarray(data["matrices"], dtype=np.int32),
            np.asarray(data["luts"], dtype=np.int32),
            int(data["amino_n"]),
        )


def names() -> list[str]:
    return list(_load()[0])


def amino_count() -> int:
    return _load()[3]


def get(name: str) -> SubstitutionMatrix:
    """Case-insensitive lookup, like the reference's parse_matrix
    (reference src/bio/matrices.c:44-57)."""
    all_names, matrices, luts, amino_n = _load()
    lname = name.lower()
    for i, n in enumerate(all_names):
        if n.lower() == lname:
            is_amino = i < amino_n
            return SubstitutionMatrix(
                name=n,
                matrix=matrices[i].copy(),
                lut=luts[0 if is_amino else 1].copy(),
                is_amino=is_amino,
            )
    raise KeyError(f"Invalid substitution matrix name: {name}")


def grouped_listing() -> str:
    """The -l/--list-matrices text, grouped 5 per line like the reference
    (reference src/bio/matrices.c:16-33)."""
    all_names, _, _, amino_n = _load()
    longest = max(len(n) for n in all_names)
    out = ["", "Listing available substitution matrices"]
    for title, group in (
        ("Amino Matrices", all_names[:amino_n]),
        ("Nucleotide Matrices", all_names[amino_n:]),
    ):
        out.append("")
        out.append(f"{title} ({len(group)}):")
        for i in range(0, len(group), 5):
            out.append("  " + " ".join(f"{n:<{longest}}" for n in group[i : i + 5]) + " ")
    return "\n".join(out) + "\n"
