"""Engine host path: mean per job of the main thread's waits on the
flusher inside the dispatch loop (``engine.flush_join`` spans whose
parent is ``engine.dispatch``): the time the main thread fed no card
because the previous flush had not finished.  From the spans that
``SEQALIGN_TPU_DEBUG_PHASES`` makes ``Engine.align_all`` record
(``sequencealigner_tpu_torch.trace``).  Each job is matched to the one
recorded run inside its wall; nothing to read when a job holds none or
several, or when the program records no spans."""


def read(r):
    try:
        from sequencealigner_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.runs_inside([(j.t0, j.t1) for j in r.jobs])
    if runs is None:
        return None
    total = 0.0
    for run in runs:
        dispatch = {s.id for s in run.named("engine.dispatch")}
        total += sum(s.seconds for s in run.named("engine.flush_join")
                     if s.parent in dispatch)
    return total / len(runs) * 1e3
