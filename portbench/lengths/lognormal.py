"""LogNormal sequence lengths: ``median`` and ``sigma`` (of the natural
log) from the configuration, rounded to whole residues; draws outside
[lo, hi] are drawn again, so the result follows the distribution truncated
to that range."""

import numpy as np


def draw(rng: np.random.Generator, n: int, params: dict, lo: int,
         hi: int) -> np.ndarray:
    mu, sigma = np.log(params["median"]), params["sigma"]
    out = np.empty(n, np.int64)
    todo = np.arange(n)
    while len(todo):
        x = np.rint(rng.lognormal(mu, sigma, len(todo))).astype(np.int64)
        ok = (x >= lo) & (x <= hi)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out
