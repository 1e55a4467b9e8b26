"""Engine host path: mean per job of the ``engine.dispatch`` span's self
time, the dispatch loop less the main-thread spans inside it (its waits
on the flusher, ``engine.flush_join``, and any flush run on the main
thread), from the spans that ``SEQALIGN_TPU_DEBUG_PHASES`` makes
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
    total = sum(run.self_seconds(s) for run in runs
                for s in run.named("engine.dispatch"))
    return total / len(runs) * 1e3
