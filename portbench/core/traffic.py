"""The general generator: a cell's pool of sequence sets from its
configuration, its workload file and ``--seed``.

Every seed gets the same sizes: set k of the pool draws its lengths from a
fixed seed of its own (``SIZES_SEED``, k), so every run does the same work;
``--seed`` draws the residues and the order of the sequences.  Lengths
come from the configuration's length model (lengths/<model>.py), truncated
to the workload's range by drawing again; a long tail, where the workload
has one, replaces that many of the draws by lengths drawn uniformly from
its own range.  Residues are drawn independently from the configuration's
composition table.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

SIZES_SEED = 20261018


@dataclasses.dataclass
class SeqSet:
    index: int
    data: np.ndarray  # (total,) uint8 residues, ASCII
    offsets: np.ndarray  # (n + 1,) int64
    long: np.ndarray  # indices of the long tail's sequences

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def seqs(self) -> list:
        return np.split(self.data, self.offsets[1:-1])


def cells(lengths) -> int:
    """True DP cells of all pairs i < j: the sum of l_i * l_j."""
    ls = [int(x) for x in lengths]
    s = sum(ls)
    return (s * s - sum(x * x for x in ls)) // 2


def seed_rng(seed: int, *more: int) -> np.random.Generator:
    """A generator for a whole-number seed of any size or sign."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *more])


def composition(bench, name: str) -> tuple[np.ndarray, np.ndarray]:
    """(residues as uint8 ASCII, probabilities) of a composition table."""
    table = json.loads(bench.data(name, ".json").read_text())["percent"]
    res = np.frombuffer("".join(table).encode(), np.uint8)
    p = np.array(list(table.values()), np.float64)
    return res, p / p.sum()


def lengths_of(bench, cell, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths, indices of the long tail) of set k, before the seed's
    order."""
    cfg, wl = cell.config, cell.workload
    rng = np.random.default_rng([SIZES_SEED, k])
    model = bench.module("lengths", cfg["lengths"]["model"])
    lo, hi = wl["lengths"]["min"], wl["lengths"]["max"]
    n = int(wl["n"])
    lens = model.draw(rng, n, cfg["lengths"], lo, hi)
    long = np.zeros(0, np.int64)
    tail = wl.get("long_tail")
    if tail:
        long = rng.choice(n, tail["count"], replace=False)
        lens[long] = rng.integers(tail["min"], tail["max"] + 1, len(long))
    return lens, long


def make_pool(bench, cell, seed: int) -> list:
    res, p = composition(bench, cell.config["composition"])
    pool = []
    for k in range(int(cell.workload["pool"])):
        lens, long = lengths_of(bench, cell, k)
        rng = seed_rng(seed, k)
        order = rng.permutation(len(lens))
        lens = lens[order]
        where = np.empty_like(order)
        where[order] = np.arange(len(order))
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        data = res[rng.choice(len(res), int(offsets[-1]), p=p)]
        pool.append(SeqSet(k, data, offsets, np.sort(where[long])))
    return pool
