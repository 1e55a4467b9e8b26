"""Kernels: the share of align_tiles' true cells that the window ran in
the tile kernel's 16-bit form (two k-lanes a thread in int16x2 DPX
lanes), weighted by cells, over the counted align_tiles launches
(core/launches.py: only where every job's launches hold exactly the
harness's cells of that job).  Each launch's form is the ``bits`` the
program's wrapper reported for it.  Nothing to read without counts, an
align_tiles launch, or a program whose counts hold no ``bits``."""

from portbench.core.launches import counted


def read(r):
    launches = counted(r)
    if launches is None:
        return None
    tiles = [x for x in launches if x.kernel == "align_tiles"]
    if not tiles or not all(hasattr(x, "bits") for x in tiles):
        return None
    cells = sum(x.cells for x in tiles)
    if cells <= 0:
        return None
    return sum(x.cells for x in tiles if x.bits == 16) / cells
