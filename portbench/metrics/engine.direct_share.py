"""Engine host path: the share of the scattered pairs that the flusher's
direct scatter wrote (tiles-v2 launch groups straight from their score
buffers into the store, with no pair arrays), over the window's jobs: the
``direct`` attribute of the ``flush.scatter`` spans over their ``pairs``,
from the spans that ``SEQALIGN_TPU_DEBUG_PHASES`` makes
``Engine.align_all`` record (``sequencealigner_tpu_torch.trace``).  Each
job is matched to the one recorded run inside its wall; nothing to read
when a job holds none or several, when the program records no spans, when
its scatter spans carry no ``direct`` count, or when nothing was
scattered."""


def read(r):
    try:
        from sequencealigner_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.runs_inside([(j.t0, j.t1) for j in r.jobs])
    if runs is None:
        return None
    spans = [s for run in runs for s in run.named("flush.scatter")]
    attrs = [s.attrs or {} for s in spans]
    if not attrs or any("direct" not in a for a in attrs):
        return None
    pairs = sum(a["pairs"] for a in attrs)
    if pairs <= 0:
        return None
    return sum(a["direct"] for a in attrs) / pairs
