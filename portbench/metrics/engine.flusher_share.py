"""Engine host path: the share of ``align_all``'s wall spent in flushes,
the ``engine.flush`` spans (one at a time, on the flusher thread or the
main one) over the ``engine.align_all`` spans, summed over the window's
jobs.  From the spans that ``SEQALIGN_TPU_DEBUG_PHASES`` makes
``Engine.align_all`` record (``sequencealigner_tpu_torch.trace``).  Each
job is matched to the one recorded run inside its wall; nothing to read
when a job holds none or several, or when the program records no
spans."""


def read(r):
    try:
        from sequencealigner_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.runs_inside([(j.t0, j.t1) for j in r.jobs])
    if runs is None:
        return None
    wall = sum(run.top.seconds for run in runs)
    if wall <= 0:
        return None
    return sum(run.total("engine.flush") for run in runs) / wall
