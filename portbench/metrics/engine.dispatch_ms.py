"""Engine host path: mean per job of the ``schedule+dispatch`` phase (the
bucket arrays' packing and upload, then the dispatch loop up to the final
flush), from the ``[phases]`` line that ``SEQALIGN_TPU_DEBUG_PHASES`` makes
``Engine.align_all`` print.  Nothing to read when a job printed no such
phase."""


def read(r):
    vals = [j.phases.get("schedule+dispatch") for j in r.jobs]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) * 1e3
