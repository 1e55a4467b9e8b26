# Copy of sequencealigner_tpu/io/output.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Result matrix store: full symmetric or packed-triangular, with disk spill.

Parity with the reference output subsystem (reference src/io/output.c):
full N x N when it fits in 3/4 of available RAM, else packed triangular
(alignments(n) = n(n-1)/2 entries at index alignments(j)+i for pair i<j,
util/macros.h:13, output.c:35-41, 68-84); a temp-file-backed array when even
that exceeds RAM (disk spill, not checkpointing).  The reference also gates
"full" on GPU memory (cuda_memory) — unnecessary here: scores stream back from
the TPU per block, the device never holds the N^2 matrix.
"""

from __future__ import annotations

import numpy as np

from .. import system, ui


def alignments(n: int) -> int:
    """n(n-1)/2, the linear pair-space size (util/macros.h:13)."""
    return n * (n - 1) // 2


class OutputStore:
    def __init__(
        self, dim: int, *, triangular: bool, spill: bool, persist_path=None,
        perm=None,
    ):
        self.dim = dim
        self.triangular = triangular
        self.spill = spill
        # Sorted-coordinate mode (disk-spill stores): the packed triangle is
        # laid out in LENGTH-SORTED space — ``perm[s]`` = original index at
        # sorted position s (the engine's Schedule.order).  The engine emits
        # flushes in combo-ordered streams whose sorted positions ascend
        # monotonically, so in this layout every flush is a run of strictly
        # ascending offsets: sequential page writes into the cold memmap (the
        # TPU-scale analogue of the reference's column-sequential fills,
        # src/io/output.c:68-84) instead of the ~10 k pairs/s random scatter
        # measured at the 1M-seq rehearsal.  All reads translate through the
        # inverse permutation, so the public API stays in original indices.
        self.perm = None
        self.pos = None
        if perm is not None:
            assert triangular, "sorted-coordinate layout is triangular-only"
            self.perm = np.ascontiguousarray(perm, dtype=np.int64)
            assert self.perm.shape == (dim,)
            self.pos = np.empty(dim, dtype=np.int64)
            self.pos[self.perm] = np.arange(dim, dtype=np.int64)
        n_elems = alignments(dim) if triangular else dim * dim
        if persist_path is not None:
            # Checkpoint mode: the matrix survives the process so a resumed
            # run finds completed blocks' scores already in place.
            from .. import checkpoint

            self.matrix = checkpoint.persistent_array(persist_path, n_elems)
        else:
            self.matrix = system.alloc_array(n_elems, np.int32, spill)

    @classmethod
    def plan(
        cls, dim: int, *, force_triangular: bool = False, persist_path=None,
        perm=None,
    ) -> "OutputStore":
        """Mode decision of output_load (output.c:35-56).  ``perm`` (the
        length-sorted order) activates the sorted-coordinate layout, but only
        when the store spills to disk — in-RAM stores scatter fine and keep
        the plain layout."""
        avail = system.available_memory()
        full_bytes = dim * dim * 4
        triangular = force_triangular or full_bytes > avail * 3 // 4
        bytes_needed = alignments(dim) * 4 if triangular else full_bytes
        spill = bytes_needed > avail * 3 // 4
        ui.pinfo("Similarity Matrix dimensions: %d x %d", dim, dim)
        if triangular:
            ui.pinfo("Using triangular matrix instead of full matrix")
        usage, unit = bytes_needed / (1 << 20), "MiB"
        if bytes_needed > (1 << 30) // 100:
            usage, unit = bytes_needed / (1 << 30), "GiB"
        ui.pinfo("Similarity Matrix size: %.2f %s", usage, unit)
        if spill and persist_path is None:
            ui.pinfom("Similarity Matrix size exceeds memory limits")
            ui.pinfol("Creating temporary file storage: %.2f %s", usage, unit)
        return cls(
            dim, triangular=triangular, spill=spill, persist_path=persist_path,
            perm=perm if (spill and triangular) else None,
        )

    def _translate(self, i: np.ndarray, j: np.ndarray):
        """Original (i < j) -> this store's coordinates (lo < hi)."""
        if self.pos is None:
            return i, j
        pi, pj = self.pos[i], self.pos[j]
        return np.minimum(pi, pj), np.maximum(pi, pj)

    def fill_pairs(self, i: np.ndarray, j: np.ndarray, scores: np.ndarray) -> None:
        """Scatter a block of pair scores; i < j elementwise (the vectorized
        equivalent of output_fill, output.c:68-84).  Uses the native OpenMP
        scatter (native/hostops.c) when available, NumPy otherwise."""
        import os

        from . import native

        i = np.ascontiguousarray(i, dtype=np.int64)
        j = np.ascontiguousarray(j, dtype=np.int64)
        s = np.ascontiguousarray(scores, dtype=np.int32)
        if self.pos is not None:
            i, j = self._translate(i, j)
            i = np.ascontiguousarray(i)
            j = np.ascontiguousarray(j)
        # On few-core hosts NumPy's vectorized scatter beats the scalar
        # OpenMP loop (measured 15.9 vs 2.0 M pairs/s on a 1-core box);
        # the native path wins once threads can share the work.
        use_native = (os.cpu_count() or 1) > 2
        if self.triangular:
            if not (use_native and native.fill_pairs_tri(self.matrix, i, j, s)):
                self.matrix[j * (j - 1) // 2 + i] = s
        else:
            if not (use_native
                    and native.fill_pairs_full(self.matrix, self.dim, i, j, s)):
                self.matrix[i * self.dim + j] = s
                self.matrix[j * self.dim + i] = s

    def read_pairs(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """Vectorized score read for pairs i < j (the inverse of fill_pairs;
        used to re-contribute resumed blocks in multi-host runs)."""
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        i, j = self._translate(i, j)
        if self.triangular:
            return np.asarray(self.matrix[j * (j - 1) // 2 + i])
        return np.asarray(self.matrix[i * self.dim + j])

    def sync(self) -> None:
        """Flush a file-backed matrix to disk (no-op for RAM stores) — called
        before the checkpoint journal commits so journaled blocks' scores are
        durable no later than the journal entry."""
        if isinstance(self.matrix, np.memmap):
            self.matrix.flush()

    def get_pair(self, i: int, j: int) -> int:
        if i == j:
            return 0
        if i > j:
            i, j = j, i
        if self.pos is not None:
            pi, pj = int(self.pos[i]), int(self.pos[j])
            i, j = min(pi, pj), max(pi, pj)
        if self.triangular:
            return int(self.matrix[alignments(j) + i])
        return int(self.matrix[i * self.dim + j])

    def row(self, r: int) -> np.ndarray:
        """Full row r (reconstructed from packed storage if triangular) —
        the per-row conversion of hdf5.c:148-163."""
        if not self.triangular:
            return np.asarray(self.matrix[r * self.dim : (r + 1) * self.dim])
        if self.pos is not None:
            return self.rows(r, r + 1)[0]
        out = np.zeros(self.dim, dtype=np.int32)
        if r > 0:  # pairs (i<r): packed at alignments(r)+i
            out[:r] = self.matrix[alignments(r) : alignments(r) + r]
        if r < self.dim - 1:  # pairs (r<j): packed at alignments(j)+r
            js = np.arange(r + 1, self.dim, dtype=np.int64)
            out[r + 1 :] = self.matrix[js * (js - 1) // 2 + r]
        return out

    def rows_sorted_window(self, s0: int, s1: int, qchunk: int = 1 << 14
                           ) -> tuple[np.ndarray, np.ndarray]:
        """SEQUENTIAL tri->square conversion unit for the sorted-coordinate
        spill layout: returns (target_rows, block) where block[t] is the
        full square-matrix row of ORIGINAL index target_rows[t], built from
        sorted rows s0 <= s < s1 of the packed triangle with two streaming
        reads (VERDICT r4 task 7 — the per-output-row gather did one random
        cold-memmap access per CELL):

        - the window's own packed rows: ONE contiguous slice
          [tri(s0), tri(s1));
        - the "column" part (sorted cols q >= s1): for ascending q, the
          R-element slice [tri(q)+s0, tri(q)+s1) — a strictly forward sweep
          of the file in ascending offsets (page-sequential), vectorized as
          ascending fancy-gathers of qchunk rows at a time.

        The caller writes block to the HDF5 dataset at target_rows (both
        returned sorted by target row so h5py's increasing-selection rule
        holds).  This mirrors the row-sequential conversion of the
        reference (src/io/format/hdf5.c:148-196), transposed into sorted
        space where THIS layout is contiguous."""
        assert self.pos is not None and self.triangular
        dim = self.dim
        R = s1 - s0
        block = np.zeros((R, dim), np.int32)  # sorted-column order first
        # Part A: sorted rows' own slices (cols < s), one contiguous read.
        flat = np.asarray(self.matrix[alignments(s0) : alignments(s1)])
        off = 0
        for t, s in enumerate(range(s0, s1)):
            block[t, :s] = flat[off : off + s]
            off += s
        # Part B: cols q in [s1, dim): forward streaming fancy-gather.
        rs = np.arange(s0, s1, dtype=np.int64)
        for q0 in range(s1, dim, qchunk):
            q1 = min(q0 + qchunk, dim)
            qs = np.arange(q0, q1, dtype=np.int64)
            idx = qs[:, None] * (qs[:, None] - 1) // 2 + rs[None, :]
            block[:, q0:q1] = np.asarray(self.matrix[idx.reshape(-1)]
                                         ).reshape(len(qs), R).T
        # Corner: cols q in (s, s1) come from the window's own rows.
        for t, s in enumerate(range(s0, s1)):
            for u in range(t + 1, R):
                block[t, s0 + u] = block[u, s]
        # Columns are sorted ids; permute to original column order.
        out = np.empty_like(block)
        out[:, self.perm] = block
        targets = self.perm[s0:s1]
        order = np.argsort(targets)
        return targets[order], out[order]

    def rows(self, start: int, end: int) -> np.ndarray:
        if self.triangular and self.pos is not None:
            # Sorted-coordinate layout: one vectorized gather per row chunk
            # through the inverse permutation (the same packed-to-square
            # read pattern as the reference's conversion, hdf5.c:148-163,
            # just permuted).
            p = self.pos[start:end, None]
            q = self.pos[None, :]
            lo = np.minimum(p, q)
            hi = np.maximum(p, q)
            hi = np.where(hi == lo, 1, hi)  # diagonal -> dummy slot 0
            lo = np.where(hi == 1, np.minimum(lo, 0), lo)
            out = np.asarray(
                self.matrix[hi * (hi - 1) // 2 + lo], dtype=np.int32
            )
            rr = np.arange(start, end)
            out[rr - start, rr] = 0  # the diagonal read a dummy slot
            return out
        if self.triangular:
            from . import native

            out = native.rows_from_tri(self.matrix, self.dim, start, end)
            if out is not None:
                return out
        return np.stack([self.row(r) for r in range(start, end)])
