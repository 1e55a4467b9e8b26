"""Kernels: the share, in percent, of align_pairs' roofline that the
window reached.  The bound is the least device time of the true cells that
the program counted for its align_pairs launches (core/roofline.py, at the
algorithm's per-cell cost); the time is the profiler's device time of the
per-pair kernel (``pairs_kernel``) alone, summed over the cards.  The
counts come through core/launches.py, so they count only where every job's
launches hold exactly the harness's cells of that job.  Nothing to read
without a trace, counts or device time of the kernel."""

from portbench.core.launches import counted


def read(r):
    if r.trace is None:
        return None
    launches = counted(r)
    if launches is None:
        return None
    cells = sum(x.cells for x in launches if x.kernel == "align_pairs")
    ms = r.trace.kernel_ms.get("pairs_kernel", 0.0)
    if cells <= 0 or ms <= 0:
        return None
    return 100.0 * r.bound_ms(cells, r.algo) / ms
