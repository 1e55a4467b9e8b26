"""Spans of the engine's host path, one run per ``Engine.align_all``.

``SEQALIGN_TPU_DEBUG_PHASES`` (read by each ``align_all``) turns recording
on, and the CLI's ``-t`` turns it on for its run.  A span is a named
interval on ``time.perf_counter()`` of one thread, ``main`` (the thread
that called ``align_all``) or ``flusher``, with its own id, the id of the
span that caused it, the id of its run and a few counts as attributes.  A
run's spans are kept in memory while it goes; a finished run joins a
bounded list of the last ``KEEP`` runs, which ``runs()`` returns.  With
no run, ``span`` records nothing and the engine computes no attribute.

The spans of a run (engine.py and flusher.py), with their thread and
attributes:

- ``engine.align_all`` (main): the whole call; ``pairs``, ``cells``,
  ``lanes``, ``schedule`` (``tiles-v2`` or ``linear-v1``).
- ``engine.pack`` (main): the bucket arrays, that is packing, pins and
  uploads to every entry (none on a cache hit); ``buckets``,
  ``h2d_bytes``.
- ``engine.dispatch`` (main): the dispatch loop up to the last launch;
  ``launches``, a count per entry.
- ``engine.flush_join`` (main): blocked on the previous flush.
- ``engine.final`` (main): the last flush and the journal commit.
- ``engine.flush`` (flusher, or main when synchronous): one flush;
  ``cause``, ``blocks``, ``pairs``, ``d2h_bytes``.
- On its flush's thread, inside it: ``flush.fetch_wait`` (the wait for
  one launch group's scores); on the direct path (a group into a
  plain-layout store with no merger, io/direct_fill.py) one
  ``flush.scatter`` a group, its scores straight into the store; on the
  triplet path ``flush.materialize`` (a group's pair arrays,
  Block.pairs), ``flush.select`` (its valid scores as int32) and, once a
  flush, ``flush.scatter`` (OutputStore.fill_pairs and the merger).  Every
  ``flush.scatter`` has ``pairs``, the pairs it scattered, and
  ``direct``, those of them the direct path wrote.  Then
  ``flush.commit`` (a journal sync point).

Beside the spans, a run counts its DP launches (``Run.dp_launches``, one
``Launch`` each, in launch order, on the main thread): the wrapper
(``align_tiles`` or ``align_pairs``), its valid pairs and true DP cells,
which the engine counts from the blocks it holds, and the lanes per pair G
and the waves of the layout the wrapper ran (``cuda_dp.pairs_waves`` and
``tiles_waves``: the launch's items over the card's resident grid; G 1 for
tiles, and waves 0 on the CPU, which has no grid), and the bits of the
form it ran (``bits``: 16 for ``align_tiles``' 16-bit form, else 32).  All
of it is counted on the host, with no device work.

A flush's parent is the main-thread span that started it (``dispatch`` or
``final``).  Its cause: ``forced`` (FLUSH_PAIRS pairs in flight),
``eager`` (the flusher was idle with dispatches in flight), ``merger`` (a
FLUSH_PAIRS point under a merger, on the main thread) or ``final``;
``Run.causes`` counts the flushes by cause.

While a ``torch.profiler`` records, ``engine.align_all`` is also a
profiler range on the main thread (``record_function``'s C++ form, an
event of category ``cpu_op``): the profiler keeps no range opened on
another thread, so ``add_chrome_events``
puts every span of a run, from both threads, on the clock of the
profiler's trace by the offset between the two starts of that one span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

#: Finished runs kept, the newest last.
KEEP = 4096
TOP = "engine.align_all"

#: One DP launch of a run (see the module's docstring).
Launch = collections.namedtuple(
    "Launch", ("kernel", "pairs", "cells", "lanes", "waves", "bits"),
    defaults=(32,))

_runs: collections.deque = collections.deque(maxlen=KEEP)
_span_ids = itertools.count(1)
_run_ids = itertools.count(1)


class Span:
    __slots__ = ("name", "t0", "t1", "thread", "tid", "id", "parent", "run",
                 "attrs")

    def __init__(self, name, t0, thread, tid, parent, run):
        self.name, self.t0, self.t1 = name, t0, None
        self.thread, self.tid = thread, tid
        self.id, self.parent, self.run = next(_span_ids), parent, run
        self.attrs = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Run:
    """The spans of one ``align_all``: a context that opens
    ``engine.align_all`` (and its ``record_function`` while a profiler
    records) and, on a normal exit, closes it and keeps the run."""

    def __init__(self):
        self.id = next(_run_ids)
        self.spans: list = []
        self.causes: dict = {}
        self.dp_launches: list = []
        self.top: Span | None = None
        self.profiled = False
        self._rf = None

    def begin(self, name: str, parent: Span, thread: str | None = None
              ) -> Span:
        """A span of ``name`` caused by ``parent``, from now; on the
        parent's thread unless ``thread`` names the calling one."""
        if thread is None:
            thread, tid = parent.thread, parent.tid
        else:
            tid = threading.get_native_id()
        span = Span(name, time.perf_counter(), thread, tid,
                    parent.id if parent is not None else None, self.id)
        self.spans.append(span)
        return span

    @staticmethod
    def end(span: Span) -> None:
        span.t1 = time.perf_counter()

    def count(self, cause: str) -> None:
        self.causes[cause] = self.causes.get(cause, 0) + 1

    def launch(self, kernel: str, pairs: int, cells: int, lanes: int,
               waves: float, bits: int = 32) -> None:
        """Counts one DP launch (``Launch``)."""
        self.dp_launches.append(
            Launch(kernel, pairs, cells, lanes, waves, bits))

    def __enter__(self) -> Run:
        if torch.autograd.profiler._is_profiler_enabled:
            # The C++ range takes its stamps within some 15 us of the
            # clock reads beside them; record_function's go through the
            # dispatcher, 100-200 us each way on a loaded host.
            fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
            self._rf = (fast or torch.profiler.record_function)(TOP)
            self._rf.__enter__()
            self.profiled = True
        self.top = self.begin(TOP, None, "main")
        return self

    def __exit__(self, exc_type, exc, tb):
        self.top.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if exc_type is None:
            _runs.append(self)
        return False

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> float:
        """Seconds of every span of ``name``."""
        return sum(s.seconds for s in self.spans if s.name == name)

    def self_seconds(self, span: Span) -> float:
        """``span``'s seconds less those of its children on its own thread
        (which nest, one after another, inside it)."""
        return span.seconds - sum(
            s.seconds for s in self.spans
            if s.parent == span.id and s.tid == span.tid)


@contextlib.contextmanager
def _timed(run: Run, name: str, parent: Span, thread: str | None):
    span = run.begin(name, parent, thread)
    yield span
    run.end(span)


def span(run: Run | None, name: str, parent: Span | None = None,
         thread: str | None = None):
    """A context that records a span of ``name`` (under ``parent``, by
    default the run's top span; ``thread`` as in ``Run.begin``) around its
    body in ``run`` and gives it, or with no run records nothing and gives
    None."""
    if run is None:
        return contextlib.nullcontext()
    return _timed(run, name, run.top if parent is None else parent, thread)


def finish(run: Run | None, wall: float, materialize: bool,
           **attrs) -> None:
    """``run``'s top span's attributes, and its ``[phases]`` line."""
    if run is None:
        return
    run.top.attrs = attrs
    print(phase_line(run, wall, materialize), flush=True)


def runs() -> list:
    """The finished runs kept, oldest first."""
    return list(_runs)


def runs_inside(intervals) -> list | None:
    """For each ``(t0, t1)`` on ``time.perf_counter()``, the one kept run
    whose ``engine.align_all`` lies inside it; None when there is no
    interval, or when one holds no run or more than one."""
    kept = runs()
    out = []
    for t0, t1 in intervals:
        inside = [r for r in kept if t0 <= r.top.t0 and r.top.t1 <= t1]
        if len(inside) != 1:
            return None
        out.append(inside[0])
    return out or None


def phase_line(run: Run, wall: float, materialize: bool) -> str:
    """The reference's ``[phases]`` line from a run's spans:
    ``schedule+dispatch`` is pack and dispatch; ``flush.materialize`` the
    pair arrays (when triplets were kept); ``flush.fetch_wait`` the rest of
    every flush but its scatter and commit; ``final_flush`` the final
    span.  Flush keys only when a flush ran."""
    sums = {"schedule+dispatch": run.total("engine.pack")
            + run.total("engine.dispatch")}
    if run.named("engine.flush"):
        mat = run.total("flush.materialize")
        if materialize:
            sums["flush.materialize"] = mat
        sums["flush.fetch_wait"] = (run.total("engine.flush") - mat
                                    - run.total("flush.scatter")
                                    - run.total("flush.commit"))
    sums["final_flush"] = run.total("engine.final")
    parts = "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sums.items())
    return f"[phases] wall={wall * 1e3:.1f}ms  {parts}"


def add_chrome_events(events: list, recorded: list) -> int:
    """Adds the spans of ``recorded`` runs to ``events``, a Chrome trace's
    ``traceEvents`` from a profiler that recorded those runs, and returns
    how many it added.  The runs recorded under that profiler, in order,
    are matched to its ``engine.align_all`` ranges, in order; each run's
    spans move by the offset between its two starts.  Each span becomes a
    complete event of category ``engine`` on its own thread's ``tid``,
    with its attributes, ids and thread name as ``args``; the run's
    ``engine.align_all`` event also holds its ``dp_launches``, one object
    of ``Launch``'s fields each."""
    anchors = sorted((e for e in events
                      if e.get("name") == TOP and e.get("ph") == "X"
                      and e.get("cat") in ("cpu_op", "user_annotation")),
                     key=lambda e: float(e["ts"]))
    mine = sorted((r for r in recorded if r.profiled), key=lambda r: r.top.t0)
    if len(anchors) != len(mine):
        raise ValueError(f"{len(mine)} recorded runs against "
                         f"{len(anchors)} {TOP} ranges in the trace")
    added = 0
    for run, a in zip(mine, anchors):
        offset = float(a["ts"]) - run.top.t0 * 1e6
        for s in run.spans:
            args = {"id": s.id, "parent": s.parent, "run": s.run,
                    "thread": s.thread, **(s.attrs or {})}
            if s is run.top:
                args["dp_launches"] = [x._asdict() for x in run.dp_launches]
            events.append({"ph": "X", "cat": "engine", "name": s.name,
                           "pid": a.get("pid"), "tid": s.tid,
                           "ts": s.t0 * 1e6 + offset,
                           "dur": s.seconds * 1e6, "args": args})
            added += 1
    return added
