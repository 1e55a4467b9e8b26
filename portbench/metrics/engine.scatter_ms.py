"""Engine host path: mean per job of the ``flush.scatter`` spans, the
scores' scatter into the store (``OutputStore.fill_pairs``) in every
flush, on whichever thread ran it, from the spans that
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
    return sum(run.total("flush.scatter") for run in runs) / len(runs) * 1e3
