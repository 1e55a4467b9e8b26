"""Entry: the 90th percentile of one job's wall (``Engine()`` to
``align_all``'s return) over the traced window's jobs, linear between
closest ranks.  In cells whose windows hold too few jobs, or whose runs
spread too widely, for the tail to carry a bound as an end-to-end metric,
this keeps it in view; read under the profiler, so it runs a little above
an untraced run's.  Nothing to read without jobs."""

from portbench.core.harness import percentile


def read(r):
    if not r.jobs:
        return None
    return percentile([j.wall for j in r.jobs], 90)
