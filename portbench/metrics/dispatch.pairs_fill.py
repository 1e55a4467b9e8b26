"""Dispatch: how full align_pairs' launches keep the card's resident grid,
weighted by their true cells.  Per launch, waves / ceil(waves), where
waves is the launch's warp items over the warps of the resident grid of
the form it ran (one-lane, or split for G > 1), as the program's wrapper
counted them from the layout it chose: below one wave the share of the
card in use, past it the share of the last wave's slots that hold work,
counted over every wave.  From the program's launch counts
(core/launches.py: only where every job's launches hold exactly the
harness's cells of that job).  Nothing to read without counts or an
align_pairs launch on a card."""

import math

from portbench.core.launches import counted


def read(r):
    launches = counted(r)
    if launches is None:
        return None
    pairs = [x for x in launches if x.kernel == "align_pairs" and x.waves > 0]
    cells = sum(x.cells for x in pairs)
    if cells <= 0:
        return None
    return sum(x.cells * x.waves / math.ceil(x.waves) for x in pairs) / cells
