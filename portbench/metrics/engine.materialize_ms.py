"""Engine host path: mean per job of the ``flush.materialize`` phase (the
flusher's pair arrays of the blocks it scatters), from the ``[phases]``
line that ``SEQALIGN_TPU_DEBUG_PHASES`` makes ``Engine.align_all`` print.
A phase is summed over the main and the flusher threads, so it is not a
part of the wall.  Nothing to read when a job printed no such phase."""


def read(r):
    vals = [j.phases.get("flush.materialize") for j in r.jobs]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) * 1e3
