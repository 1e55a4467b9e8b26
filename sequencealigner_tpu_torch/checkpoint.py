# Copy of sequencealigner_tpu/checkpoint.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Checkpoint / resume by pair-block.

The reference has no checkpointing (SURVEY.md §5: its disk-backed matrix is
spill, deleted on exit).  Because this engine schedules the N(N-1)/2 pair
space as a deterministic stream of superblocks, resume comes nearly for free:
persist the result matrix in a file-backed array and journal which global
block indices have been flushed into it.  On restart with the same
configuration, completed blocks are skipped and their scores are already in
the store.

Journal format: line 1 is a JSON header binding the run configuration
(algorithm, gaps, matrix, input digest, sequence count, storage mode); each
subsequent line is a JSON array of global block indices committed by one
flush.  Lines are appended with flush+fsync AFTER the store scatter, so a
crash can only lose the tail flush (which is then recomputed).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


class CheckpointError(Exception):
    pass


def config_fingerprint(
    *, algo: str, gaps: tuple[int, int, int], matrix: str,
    num_seqs: int, lengths: np.ndarray, triangular: bool,
    data: np.ndarray | bytes | None = None,
    schedule: str = "linear-v1",
) -> dict:
    h = hashlib.sha256(np.asarray(lengths, np.int64).tobytes()).hexdigest()[:16]
    fp = {
        "algo": algo,
        "gaps": list(gaps),
        "matrix": matrix,
        "num_seqs": int(num_seqs),
        "lengths_sha": h,
        "triangular": bool(triangular),
        # Journals record GLOBAL BLOCK INDICES, which only mean the same
        # pairs under the same block-schedule geometry (linear superblocks
        # vs outer-product tiles) — resuming across engines that schedule
        # differently must be rejected (Engine.schedule_token).
        "schedule": schedule,
    }
    if data is not None:
        # Digest of the actual sequence BYTES, not just lengths: resuming
        # against an edited input whose lengths happen to match (point
        # mutations, regenerated data) must be rejected, or journaled blocks
        # would silently contribute stale scores to the matrix.
        buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        fp["data_sha"] = hashlib.sha256(buf).hexdigest()[:16]
    return fp


class Journal:
    """Append-only record of completed global block indices."""

    def __init__(self, path: str | Path, header: dict):
        self.path = Path(path)
        self.done: set[int] = set()
        if self.path.exists():
            with open(self.path, "rb") as f:
                raw = f.read()
            file_len = len(raw)
            # A crash can tear the tail exactly after a complete JSON line
            # but before its newline; that line would parse, survive, and the
            # append-mode reopen would concatenate the next commit onto it
            # ("[5,6][7,8]") — losing BOTH flushes on the following resume.
            # Treat any un-newline-terminated tail as torn up front.
            if raw and not raw.endswith(b"\n"):
                raw = raw[: raw.rfind(b"\n") + 1]
            lines = raw.split(b"\n")
            first = lines[0].decode() if lines else ""
            try:
                existing = json.loads(first) if first.strip() else None
            except json.JSONDecodeError:
                raise CheckpointError("Checkpoint journal header is corrupt")
            if existing != header:
                diff = []
                if isinstance(existing, dict):
                    for k in sorted(set(existing) | set(header)):
                        a, b = existing.get(k), header.get(k)
                        if a != b:
                            diff.append(f"{k}: journal={a!r} run={b!r}")
                detail = "; ".join(diff) or "unreadable header"
                hint = ""
                if any(d.startswith("schedule:") for d in diff):
                    hint = (
                        " (the block-schedule geometry changed — e.g. a "
                        "different engine version or device path; the "
                        "journal's block indices do not map to the same "
                        "pairs, so the run must restart from scratch)"
                    )
                raise CheckpointError(
                    "Checkpoint was created with a different configuration: "
                    + detail + hint
                )
            # A crash mid-commit can tear the LAST line; tolerate it by
            # truncating to the last complete line (that flush is simply
            # recomputed).  A torn line anywhere else is real corruption.
            good_end = len(first.encode()) + 1
            for k, line in enumerate(lines[1:], start=1):
                if not line.strip():
                    good_end += len(line) + 1
                    continue
                try:
                    self.done.update(json.loads(line))
                except json.JSONDecodeError:
                    if any(x.strip() for x in lines[k + 1 :]):
                        raise CheckpointError(
                            "Checkpoint journal is corrupt mid-file"
                        )
                    break
                good_end += len(line) + 1
            good_end = min(good_end, len(raw))
            if good_end < file_len:
                with open(self.path, "r+b") as f:
                    f.truncate(good_end)
            self._f = open(self.path, "a")
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "w")
            self._f.write(json.dumps(header) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def commit(self, block_ids: list[int]) -> None:
        if not block_ids:
            return
        self._f.write(json.dumps(block_ids) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self.done.update(block_ids)

    def close(self) -> None:
        self._f.close()


def persistent_array(path: str | Path, n_elems: int, dtype=np.int32):
    """File-backed zeroed array that survives the process (unlike the spill
    tmpfile) — the checkpoint store."""
    path = Path(path)
    nbytes = int(n_elems) * np.dtype(dtype).itemsize
    exists = path.exists() and path.stat().st_size == nbytes
    if not exists:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            f.truncate(nbytes)
    return np.memmap(path, dtype=dtype, mode="r+", shape=(int(n_elems),))
