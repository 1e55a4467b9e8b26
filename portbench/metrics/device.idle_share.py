"""Device: the share of the traced window in which a card ran nothing (no
kernel, copy or fill), from the profiler's trace, averaged over the cell's
cards.  Nothing to read without a trace."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    w = r.trace.window_s
    idle = [1.0 - r.trace.busy_s.get(c, 0.0) / w for c in r.cards]
    return sum(idle) / len(idle)
