# Copy of sequencealigner_tpu/io/dsv.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""DSV (csv/tsv/ssv/psv) parser with the reference's exact semantics
(reference src/io/source/dsv.c):

- delimiter by extension: csv ',', tsv TAB, ssv ';', psv '|'
- RFC-style quoting incl. doubled '""' escapes; one outer quote pair stripped
  per field; quoted fields may span newlines (dsv.c:26-57)
- header row parsed; sequence column auto-detected by case-insensitive name
  match against sequence/seq/protein/dna/rna/amino/peptide/chain (dsv.c:21-24)
- otherwise an interactive column chooser incl. a "No header line" option
  (dsv.c:138-151) — never auto-answered, even under -F
- per-row column-count validation; sequences cleaned like FASTA but also
  dropping '"' characters (dsv.c:180-194)

A quote-free fast path uses C-speed bytes splitting; files containing '"'
take the exact char-scan path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .. import ui
from .input import ParseError, Unsupported, check_lengths, clean_sequence

DELIMS = {"csv": ord(","), "tsv": ord("\t"), "ssv": ord(";"), "psv": ord("|")}
KEYS = ("sequence", "seq", "protein", "dna", "rna", "amino", "peptide", "chain")


def _field(data: bytes, pos: int, delim: int) -> tuple[bytes, int]:
    """dsv_field (dsv.c:26-57): returns (field, new_pos); new_pos is past a
    trailing delimiter but AT a row terminator."""
    n = len(data)
    start = pos
    quoted = False
    while pos < n:
        c = data[pos]
        if c == 34:  # '"'
            if quoted and pos + 1 < n and data[pos + 1] == 34:
                pos += 2
                continue
            quoted = not quoted
            pos += 1
            continue
        if not quoted and (c == delim or c in (10, 13)):
            break
        pos += 1
    f = data[start:pos]
    if len(f) >= 2 and f[0] == 34 and f[-1] == 34:
        f = f[1:-1]
    if pos < n and data[pos] == delim:
        pos += 1
    return f, pos


def _cols(data: bytes, delim: int) -> int:
    """Column count of the first row, quote-aware (dsv_cols, dsv.c:59-76)."""
    count = 1
    quoted = False
    pos, n = 0, len(data)
    while pos < n:
        c = data[pos]
        if c == 34:
            if quoted and pos + 1 < n and data[pos + 1] == 34:
                pos += 2
                continue
            quoted = not quoted
        elif c == delim and not quoted:
            count += 1
        if not quoted and c in (10, 13):
            break
        pos += 1
    return count


def _detect_column(
    headers: list[bytes], cols: int, choose: Callable[[list[str], str], int]
) -> tuple[int, bool]:
    """Returns (seq_col, header_is_data).  Auto-detect by KEYS, else the
    interactive flow of dsv.c:138-151."""
    for col, h in enumerate(headers):
        if h.decode("latin-1").lower() in KEYS:
            return col, False
    opts = [h.decode("latin-1") for h in headers] + ["No header line"]
    ui.pinfol("Which column contains your sequences?")
    choice = choose(opts, "Enter column number")
    if choice == cols:
        ui.pinfol("Which column contains a sequence?")
        return choose(opts[:cols], "Enter column number"), True
    return choice, False


def parse(
    data: bytes,
    ext: str,
    lut: np.ndarray,
    *,
    gap_pen: int = 0,
    choose: Callable[[list[str], str], int] | None = None,
) -> list[np.ndarray]:
    ui.pverbm("Trying out DSV parser")
    delim = DELIMS.get(ext.lower())
    if delim is None:
        raise Unsupported(ext)
    ui.pverbm("Using DSV parser")
    choose = choose or ui.pchoice

    cols = _cols(data, delim)
    pos = 0
    headers = []
    for _ in range(cols):
        f, pos = _field(data, pos, delim)
        if not f:
            raise ParseError("First row has empty column")
        headers.append(f)
    n = len(data)
    while pos < n and data[pos] in (10, 13):
        pos += 1

    seq_col, header_is_data = _detect_column(headers, cols, choose)
    start = 0 if header_is_data else pos

    if 34 not in data:
        from . import native

        nat = native.dsv_fast(data[start:], lut, gap_pen, delim, cols, seq_col)
        if nat is not None:
            ui.pverbl("DSV parsing finished successfuly (native)")
            return nat
        return _parse_fast(data[start:], delim, cols, seq_col, lut, gap_pen)
    return _parse_quoted(data, start, delim, cols, seq_col, lut, gap_pen)


def _parse_fast(body, delim, cols, seq_col, lut, gap_pen):
    seqs: list[np.ndarray] = []
    total = 0
    num = 0
    d = bytes([delim])
    for line in body.replace(b"\r", b"\n").split(b"\n"):
        if not line:
            continue
        num += 1
        fields = line.split(d)
        # Error precedence matches the reference row loop (dsv.c:164-224):
        # missing seq column, then sequence errors, then column-count errors.
        if len(fields) <= seq_col:
            raise ParseError(f"DSV row #{num} has no sequence column")
        raw = fields[seq_col]
        if not raw:
            raise ParseError(f"Sequence #{num} is empty")
        seq = clean_sequence(raw, num, lut, drop_quotes=True)
        check_lengths(len(seq), total, num, gap_pen)
        if len(fields) < cols:
            raise ParseError(f"DSV row #{num} has too few columns")
        if len(fields) > cols:
            raise ParseError(f"DSV row #{num} has too many columns")
        total += len(seq) + 1
        seqs.append(seq)
    ui.pverbl("DSV parsing finished successfuly")
    return seqs


def _parse_quoted(data, pos, delim, cols, seq_col, lut, gap_pen):
    seqs: list[np.ndarray] = []
    total = 0
    num = 0
    n = len(data)
    while pos < n:
        while pos < n and data[pos] in (10, 13):
            pos += 1
        if pos >= n:
            break
        num += 1
        for _ in range(seq_col):
            _, pos = _field(data, pos, delim)
            if pos >= n or data[pos] in (10, 13):
                raise ParseError(f"DSV row #{num} has no sequence column")
        raw, pos = _field(data, pos, delim)
        if not raw:
            raise ParseError(f"Sequence #{num} is empty")
        seq = clean_sequence(raw, num, lut, drop_quotes=True)
        check_lengths(len(seq), total, num, gap_pen)
        total += len(seq) + 1
        seqs.append(seq)
        for _ in range(seq_col + 1, cols):
            if pos >= n or data[pos] in (10, 13):
                raise ParseError(f"DSV row #{num} has too few columns")
            _, pos = _field(data, pos, delim)
        if pos < n and data[pos] not in (10, 13):
            raise ParseError(f"DSV row #{num} has too many columns")
    ui.pverbl("DSV parsing finished successfuly")
    return seqs
