"""Kernels: the share, in percent, of the DP kernels' roofline that the
window reached.  The bound is the least device time of every true DP cell
of the window's jobs (core/roofline.py, at the algorithm's per-cell cost);
the time is the profiler's device time of every DP kernel (align_tiles,
align_pairs, align_grid), summed over the cards.  Summing every DP kernel
keeps the share meaningful whichever kernel does the work.  Nothing to read
without device time of a DP kernel."""


def read(r):
    if r.trace is None:
        return None
    ms = sum(r.trace.kernel_ms.values())
    if ms <= 0:
        return None
    cells = sum(j.cells for j in r.jobs)
    return 100.0 * r.bound_ms(cells, r.algo) / ms
