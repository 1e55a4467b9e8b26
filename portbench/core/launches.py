"""The program's count of its DP launches in a traced window, held to the
harness's own count of the window's cells.

``SEQALIGN_TPU_DEBUG_PHASES`` makes ``Engine.align_all`` keep, on each
recorded run, one entry a DP launch (``Run.dp_launches`` of
``sequencealigner_tpu_torch.trace``): the kernel's wrapper, its valid
pairs, its true cells, and the lanes per pair and waves of the layout the
wrapper ran.  A reader of them goes through ``counted`` so
that its yardstick stays the workload's: the launches count only when
their cells add up, job by job, to the cells the harness computed from the
lengths it generated (``traffic.cells``).
"""


def counted(r) -> list | None:
    """The DP launches of the window's jobs (``Readings`` ``r``), each job
    matched to the one recorded run inside its wall; None when a job holds
    none or several, when the program keeps no launch counts, or when a
    job's launches do not hold exactly its true cells."""
    try:
        from sequencealigner_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.runs_inside([(j.t0, j.t1) for j in r.jobs])
    if runs is None:
        return None
    out = []
    for job, run in zip(r.jobs, runs):
        launches = getattr(run, "dp_launches", None)
        if not launches or sum(x.cells for x in launches) != job.cells:
            return None
        out.extend(launches)
    return out
