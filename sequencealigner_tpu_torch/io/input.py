# Copy of sequencealigner_tpu/io/input.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Input loading: file slurp, parser registry dispatch, sequence container.

Parity with the reference input subsystem (reference src/io/input.c):
whole-file read capped at 2 GiB (input.c:42), extension-based parser registry
tried in order (input.c:46-56), >= 2 sequences enforced (input.c:63), gap-aware
length limit (input.c:15-19), and identical error messages.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .. import ui

S32_MAX = 2**31 - 1
SEQ_N_MIN = 2
SEQ_LEN_MIN = 1
SEQ_LEN_MAX = (S32_MAX - 1) // SEQ_N_MIN  # reference src/bio/align.h:23


class ParseError(Exception):
    """Input is recognized by a parser but malformed."""


class Unsupported(Exception):
    """Parser does not handle this file extension."""


@dataclasses.dataclass
class SequenceSet:
    """Packed sequences: concatenated cleaned bytes + offsets, mirroring the
    reference's in-place compaction + meta build (input.c:70-81)."""

    data: np.ndarray  # (total,) uint8 concatenated sequence bytes
    offsets: np.ndarray  # (num+1,) int64
    lut: np.ndarray  # (128,) int32 char->index LUT active at parse time

    @property
    def num(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.num else 0

    def get_bytes(self, i: int) -> bytes:
        return self.data[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def get_str(self, i: int) -> str:
        return self.get_bytes(i).decode("ascii")

    @staticmethod
    def from_list(seqs: list[np.ndarray], lut: np.ndarray) -> "SequenceSet":
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        data = (
            np.concatenate(seqs).astype(np.uint8)
            if seqs
            else np.zeros(0, dtype=np.uint8)
        )
        return SequenceSet(data=data, offsets=offsets, lut=np.asarray(lut, np.int32))

    def indices_padded(self, pad_to: int, pad_value: int) -> np.ndarray:
        """(num, pad_to) int8/int32 LUT-index matrix, pad_value beyond length."""
        idx = np.full((self.num, pad_to), pad_value, dtype=np.int32)
        lut = self.lut
        for i in range(self.num):
            s = self.data[self.offsets[i] : self.offsets[i + 1]]
            idx[i, : len(s)] = lut[s]
        return idx


def sequence_length_limit(length: int, gap_pen: int) -> bool:
    """Max length tightened so i*GAP_PEN cannot overflow s32 (input.c:15-19).
    ``gap_pen`` is the stored (negated, <= 0) linear penalty."""
    gap = -gap_pen
    return length <= (SEQ_LEN_MAX // gap if gap else SEQ_LEN_MAX)


def clean_sequence(
    raw: bytes, seq_no: int, lut: np.ndarray, *, drop_quotes: bool = False
) -> np.ndarray:
    """Uppercase, strip CR/LF/space (and '\"' for DSV), validate every char
    through the LUT — the per-byte loop of fasta.c:44-58 / dsv.c:180-194,
    vectorized."""
    arr = np.frombuffer(raw.upper(), dtype=np.uint8)
    drop = (arr == 13) | (arr == 10) | (arr == 32)
    if drop_quotes:
        drop |= arr == 34
    arr = arr[~drop]
    if arr.size:
        corrupted = (arr == 0) | (arr > 127)
        invalid = ~corrupted & (lut[np.minimum(arr, 127)] < 0)
        if corrupted.any() or invalid.any():
            ci = int(np.argmax(corrupted)) if corrupted.any() else len(arr)
            ii = int(np.argmax(invalid)) if invalid.any() else len(arr)
            if ci < ii:
                raise ParseError(f"Sequence #{seq_no} is corrupted")
            raise ParseError(f"Sequence #{seq_no} is invalid")
    return arr


def check_lengths(slen: int, total: int, seq_no: int, gap_pen: int) -> None:
    """Shared post-clean checks (fasta.c:60-77, dsv.c:196-205)."""
    if slen == 0:
        raise ParseError(f"Sequence #{seq_no} is empty")
    if slen < SEQ_LEN_MIN or not sequence_length_limit(slen, gap_pen):
        raise ParseError(f"Sequence #{seq_no} exceeds length limits")
    if total + slen + 1 > S32_MAX:
        raise ParseError(f"Length overflow after {seq_no} sequences")


def load(path: str | Path, lut: np.ndarray, *, gap_pen: int = 0) -> SequenceSet:
    """Load + parse + validate an input file.  Parser choice by extension,
    tried in registration order like the linker-section registry walk
    (input.c:46-56)."""
    from . import dsv, fasta

    path = Path(path)
    name = path.name
    if "." not in name.lstrip("."):
        raise ParseError(f"File extension not found: {name}")
    ext = name.rsplit(".", 1)[1]

    ui.pverb("Copying %s into memory", name)
    data = path.read_bytes()
    if len(data) > S32_MAX:
        raise ParseError(f"Input file too large (max 2 GiB): {name}")

    ui.pverbm("Trying out parsers for %s", name)
    for parser in (fasta.parse, dsv.parse):
        try:
            seqs = parser(data, ext, lut, gap_pen=gap_pen)
        except Unsupported:
            continue
        break
    else:
        raise ParseError(f"Unsupported file format: {name}")

    if len(seqs) < SEQ_N_MIN:
        raise ParseError(f"Not enough sequences: {len(seqs)} (min: {SEQ_N_MIN})")
    return SequenceSet.from_list(seqs, lut)
