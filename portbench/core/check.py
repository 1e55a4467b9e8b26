"""The comparison that decides ``correct``.

After each timed job the harness reads, from the score matrix that job left
in its store, a sample drawn from ``--seed`` and the job's number:

- random ordered pairs (i, j), i != j, over the whole square: both
  triangles, and pairs of every route (tile kernel, diagonal remainder,
  per-pair kernel, every card);
- near pairs: i and a sequence within 63 places of it in order of length,
  which the program puts in the same length window, so that the diagonal
  remainder (the per-window triangles the tile stream leaves out) is
  sampled densely;
- where the workload has a long tail: after each of its first
  ``long_pairs.every_in_first_jobs`` jobs (one a set of the pool, as the
  jobs cycle through it) every pair that holds a sequence of the long tail,
  both ways round, and after every later job ``long_pairs.sample`` of them
  drawn from the seed;
- the whole diagonal, which must be 0.

Once the window has closed and the program's state is freed, the reference
(reference/dp.py) scores each distinct pair once, and every value read is
compared with it exactly.  The numbers compared, each with its limit:

    mismatched_scores   values read that differ from the reference   0
    nonzero_diagonal    diagonal entries that are not 0             0
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..reference import dp
from .traffic import seed_rng

#: Numbers compared, and their limits: the comparison is exact.
LIMITS = {"mismatched_scores": 0, "nonzero_diagonal": 0}
NEAR = 63


@dataclasses.dataclass
class Sample:
    set_index: int
    i: np.ndarray  # ordered pairs read
    j: np.ndarray
    kind: np.ndarray  # 0 random, 1 near, 2 long tail
    values: np.ndarray | None = None
    diag_nonzero: int = 0


def plan(seqset, check: dict, seed: int, job: int) -> Sample:
    """The pairs read after job ``job``, drawn from the seed."""
    rng = seed_rng(seed, 1 << 20, job)
    n = seqset.n
    parts = []
    r = int(check.get("random_pairs", 0))
    if r:
        i = rng.integers(0, n, r)
        j = rng.integers(0, n - 1, r)
        parts.append((i, j + (j >= i), 0))
    m = int(check.get("near_pairs", 0))
    if m:
        order = np.argsort(seqset.lengths, kind="stable")
        p = rng.integers(0, n, m)
        d = rng.integers(1, NEAR + 1, m) * rng.choice([-1, 1], m)
        q = np.clip(p + d, 0, n - 1)
        q = np.where(q != p, q, np.where(p + 1 < n, p + 1, p - 1))
        i, j = order[p], order[q]
        flip = rng.random(m) < 0.5
        parts.append((np.where(flip, j, i), np.where(flip, i, j), 1))
    lp = check.get("long_pairs") or {}
    if lp and len(seqset.long):
        others = np.arange(n)
        if job < lp["every_in_first_jobs"]:
            for a in seqset.long:
                b = others[others != a]
                parts.append((np.full(len(b), a), b, 2))
                parts.append((b, np.full(len(b), a), 2))
        elif lp["sample"]:
            a = rng.choice(seqset.long, lp["sample"])
            b = rng.integers(0, n - 1, lp["sample"])
            b = b + (b >= a)
            flip = rng.random(len(a)) < 0.5
            parts.append((np.where(flip, b, a), np.where(flip, a, b), 2))
    i = np.concatenate([p[0] for p in parts]).astype(np.int64)
    j = np.concatenate([p[1] for p in parts]).astype(np.int64)
    kind = np.concatenate([np.full(len(p[0]), p[2], np.int8) for p in parts])
    return Sample(seqset.index, i, j, kind)


def read(sample: Sample, matrix: np.ndarray, n: int) -> None:
    """Fill ``sample`` from a job's flat (n * n) score matrix."""
    sq = np.asarray(matrix).reshape(n, n)
    sample.values = sq[sample.i, sample.j].astype(np.int64)
    sample.diag_nonzero = int(np.count_nonzero(np.diagonal(sq)))


def _keys(sample: Sample, n: int) -> np.ndarray:
    lo = np.minimum(sample.i, sample.j)
    hi = np.maximum(sample.i, sample.j)
    return lo * n + hi


def reference_scores(samples: list, pool: list, lut, sub, algo: str, gaps,
                     *, device, budget: int = 1 << 26, band=None) -> dict:
    """{set index: (sorted pair keys, reference scores)} for every distinct
    unordered pair that the samples read."""
    out = {}
    for k in sorted({s.set_index for s in samples}):
        st = pool[k]
        keys = np.unique(np.concatenate(
            [_keys(s, st.n) for s in samples if s.set_index == k]))
        codes = np.asarray(lut)[st.data]
        out[k] = (keys, dp.scores(algo, codes, st.offsets, keys // st.n,
                                  keys % st.n, sub, gaps, device=device,
                                  budget=budget, band=band))
    return out


def compare(samples: list, pool: list, ref: dict) -> dict:
    """The numbers compared, and counts of what was read."""
    mismatched = nonzero = 0
    read_by_kind = np.zeros(3, np.int64)
    for s in samples:
        keys, scores = ref[s.set_index]
        want = scores[np.searchsorted(keys, _keys(s, pool[s.set_index].n))]
        mismatched += int(np.count_nonzero(s.values != want))
        nonzero += s.diag_nonzero
        read_by_kind += np.bincount(s.kind, minlength=3)
    return {
        "numbers": {"mismatched_scores": mismatched,
                    "nonzero_diagonal": nonzero},
        "read": {"random": int(read_by_kind[0]), "near": int(read_by_kind[1]),
                 "long_tail": int(read_by_kind[2]),
                 "diagonal": sum(pool[s.set_index].n for s in samples)},
        "distinct_pairs": sum(len(v[0]) for v in ref.values()),
        "reference_cells": sum(
            int((pool[k].lengths[v[0] // pool[k].n]
                 * pool[k].lengths[v[0] % pool[k].n]).sum())
            for k, v in ref.items()),
    }


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
