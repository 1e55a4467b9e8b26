# Copy of sequencealigner_tpu/io/fasta.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""FASTA parser with the reference's exact semantics
(reference src/io/source/fasta.c):

- extensions fasta/fa/fas/fna/ffn/faa/frn/mpfa (case-insensitive)
- first byte must be '>' ("Data before first header")
- a record's header line runs to the first CR/LF (a '>' inside a header line
  does NOT start a new record); sequence bytes run to the next '>' anywhere
- EOF immediately after a header -> "Last header has no data"
- sequence bytes uppercased, CR/LF/space stripped, validated through the
  active matrix LUT; empty / over-limit / overflow checks per record
"""

from __future__ import annotations

import numpy as np

from .. import ui
from .input import ParseError, Unsupported, check_lengths, clean_sequence

EXTS = ("fasta", "fa", "fas", "fna", "ffn", "faa", "frn", "mpfa")


def parse(data: bytes, ext: str, lut: np.ndarray, *, gap_pen: int = 0) -> list[np.ndarray]:
    ui.pverbm("Trying out FASTA parser")
    if ext.lower() not in EXTS:
        raise Unsupported(ext)

    ui.pverbm("Using FASTA parser")
    from . import native

    nat = native.fasta(data, lut, gap_pen)
    if nat is not None:
        ui.pverbl("FASTA parsing finished successfuly (native)")
        return nat
    n = len(data)
    if n == 0 or data[0] != ord(">"):
        raise ParseError("Data before first header")

    seqs: list[np.ndarray] = []
    total = 0
    pos = 0
    num = 0
    while pos < n:
        # Header line: to first CR/LF (fasta.c:36-37).
        e_lf = data.find(b"\n", pos)
        e_cr = data.find(b"\r", pos)
        ends = [e for e in (e_lf, e_cr) if e != -1]
        p = min(ends) if ends else n
        while p < n and data[p] in (10, 13):
            p += 1
        if p >= n:
            raise ParseError("Last header has no data")

        num += 1
        nxt = data.find(b">", p)
        if nxt == -1:
            nxt = n
        seq = clean_sequence(data[p:nxt], num, lut)
        check_lengths(len(seq), total, num, gap_pen)
        total += len(seq) + 1
        seqs.append(seq)
        pos = nxt

    ui.pverbl("FASTA parsing finished successfuly")
    return seqs
