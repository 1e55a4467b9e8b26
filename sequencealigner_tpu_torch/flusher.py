"""The engine's flusher: launch groups' scores from the device into the
store, through the merger if there is one, and the checkpoint journal's
commits.  ``forced`` and ``eager`` flushes (trace.py: causes) run on a
background thread while later dispatches go on, one at a time; ``final``,
and under a merger every flush (its collectives run at every flush point),
run on the calling thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from . import trace
from .io import direct_fill


@dataclasses.dataclass(eq=False)
class Pending:
    """One launch group on its way from the device."""

    host: object  # its scores: pinned host memory, or the CPU tensor
    event: object  # the copy's completion (torch.cuda.Event), None on CPU
    blocks: list  # (global block index, block), in launch order
    lane: int  # the engine's entry that ran it
    claimed: bool = False  # its pairs are on the progress bar


def _cat(triplets: list) -> tuple:
    """One (i, j, scores) of a list of them."""
    if not triplets:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    return tuple(map(np.concatenate, zip(*triplets)))


class Flusher:
    """The flushes of one ``Engine.align_all``, counted into ``stats``;
    ``rec`` is its trace.Run, ``bar`` its progress bar (or None); journal
    commits are ``sync_interval`` seconds apart (0: every flush)."""

    def __init__(self, store, *, merger, journal, stats, rec, bar,
                 sync_interval: float):
        self.store, self.merger, self.journal = store, merger, journal
        self.stats, self.rec, self.bar = stats, rec, bar
        self.sync_interval = sync_interval
        #: Whether scores are kept: a store or a merger takes them.  A
        #: group goes straight into a plain-layout store with no merger
        #: (``_fill``); else, if kept, as triplets (Block.pairs) that the
        #: merger and ``fill_pairs`` take once a flush; else (the CLI's -W)
        #: only its cells are counted.
        self.keep = store is not None or merger is not None
        self._fill = (direct_fill.filler(store) if merger is None
                      else None)
        #: The main thread's span that flushes and joins start from.
        self.parent = None
        self._lock = threading.Lock()  # pending groups and their claims
        self._pending: list = []
        self._thread = None  # the outstanding background flush
        self._exc = None  # its exception
        self._backlog: list = []  # flushed block indices awaiting a sync
        self._resumed: list = []  # journaled blocks' triplets (merger)
        self._last_sync = time.perf_counter()
        self._poll_stop = threading.Event()
        self._poller = None
        if bar:
            self._poller = threading.Thread(target=self._poll, daemon=True)
            self._poller.start()

    def add(self, host, event, blocks: list, lane: int) -> None:
        with self._lock:
            self._pending.append(Pending(host, event, blocks, lane))

    def ready(self) -> bool:
        """Groups are pending and no background flush runs."""
        return bool(self._pending) and (
            self._thread is None or not self._thread.is_alive())

    def resume(self, blk) -> None:
        """A journaled block, skipped: under a merger its stored scores are
        re-contributed at the next flush, so peers that lost theirs
        converge too."""
        if self.merger is not None and self.store is not None:
            v = blk.valid
            oi, oj = blk.orig_i[v], blk.orig_j[v]
            self._resumed.append((oi, oj, self.store.read_pairs(oi, oj)))

    def flush(self, cause: str) -> None:
        """Flush what is pending: ``forced`` or ``eager`` on the flusher
        thread, ``final`` on this one; under a merger on this thread at
        every call, even with nothing pending."""
        self.join()
        with self._lock:
            batch, self._pending = self._pending, []
        if self.merger is not None:
            if cause != "final":
                cause = "merger"
        elif not batch:
            return
        if self.rec is not None:
            self.rec.count(cause)
        if self.merger is not None or cause == "final":
            self._flush(batch, cause, self.parent, "main")
        else:
            self._thread = threading.Thread(
                target=self._background, args=(batch, cause, self.parent),
                daemon=True)
            self._thread.start()

    def join(self) -> None:
        """Waits for the background flush, and raises its exception."""
        if self._thread is not None:
            with trace.span(self.rec, "engine.flush_join", self.parent):
                thread, self._thread = self._thread, None
                thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def finish(self, parent) -> None:
        """After the last launch: stops the progress poller, then the final
        flush under the main thread's span ``parent``; on return every
        score is in the store and, in a journal run, the last blocks are
        durable and journaled."""
        if self._poller is not None:
            self._poll_stop.set()
            self._poller.join(timeout=2.0)
        self.parent = parent
        self.flush("final")
        self.join()
        if self.journal is not None and self._backlog:
            self._sync_commit()

    def _background(self, batch, cause, parent) -> None:
        try:
            self._flush(batch, cause, parent, "flusher")
        except BaseException as e:  # re-raised on the main thread at join
            self._exc = e

    def _flush(self, batch: list, cause: str, parent, thread: str) -> None:
        """Fetch ``batch``'s scores, scatter them into the store (through
        the merger, if any) and commit their blocks to the journal."""
        rec, stats, bar = self.rec, self.stats, self.bar
        with trace.span(rec, "engine.flush", parent, thread) as fs:
            with self._lock:
                claimed = [not e.claimed for e in batch]
                for e in batch:
                    e.claimed = True
            got, committed = [], []  # got: the triplet path's (i, j, s)
            for e, unclaimed in zip(batch, claimed):
                if e.event is not None:
                    with trace.span(rec, "flush.fetch_wait", fs):
                        e.event.synchronize()
                buf = e.host.numpy()
                if self._fill is not None:
                    with trace.span(rec, "flush.scatter", fs) as sp:
                        stats.cells += self._fill(
                            buf, [blk for _, blk in e.blocks])
                        if sp:
                            n = sum(blk.n_valid for _, blk in e.blocks)
                            sp.attrs = {"pairs": n, "direct": n}
                elif self.keep:
                    with trace.span(rec, "flush.materialize", fs):
                        triplets = [blk.pairs() for _, blk in e.blocks]
                    with trace.span(rec, "flush.select", fs):
                        off = 0
                        for (_, blk), (oi, oj, cells) in zip(e.blocks,
                                                             triplets):
                            s = blk.select_valid(buf[off : off + blk.width])
                            got.append((oi, oj, s.astype(np.int32)))
                            off += blk.width
                            stats.cells += cells
                else:
                    stats.cells += sum(blk.cells for _, blk in e.blocks)
                for idx, blk in e.blocks:
                    committed.append(idx)
                    stats.pairs += blk.n_valid
                    if bar and unclaimed:
                        bar.add(blk.n_valid)
            if self.merger is not None or got:
                with trace.span(rec, "flush.scatter", fs) as sp:
                    got += self._resumed
                    self._resumed.clear()
                    oi, oj, s = _cat(got)
                    if self.merger is not None:
                        oi, oj, s = self.merger(oi, oj, s)
                    if self.store is not None and len(s):
                        self.store.fill_pairs(oi, oj, s)
                    if sp:
                        sp.attrs = {"pairs": len(s) if self.store is not None
                                    else 0, "direct": 0}
            if self.journal is not None:
                self._backlog.extend(committed)
                if (self.sync_interval <= 0 or time.perf_counter()
                        - self._last_sync >= self.sync_interval):
                    with trace.span(rec, "flush.commit", fs):
                        self._sync_commit()
            if fs:
                fs.attrs = {
                    "cause": cause, "blocks": len(committed),
                    "pairs": sum(blk.n_valid for e in batch
                                 for _, blk in e.blocks),
                    "d2h_bytes": sum(e.host.nbytes for e in batch
                                     if e.event is not None)}

    def _sync_commit(self) -> None:
        """Scores durable first, then the journal entry naming them."""
        if self.store is not None:
            self.store.sync()
        self.journal.commit(self._backlog)
        self._backlog.clear()
        self._last_sync = time.perf_counter()

    def _poll(self) -> None:
        # Live progress between flushes: Event.query() is a non-blocking
        # completion probe of each entry's oldest unclaimed group
        # (completion is in order on one stream).
        while not self._poll_stop.wait(0.25):
            heads = {}
            with self._lock:
                for x in self._pending:
                    if not x.claimed:
                        heads.setdefault(x.lane, x)
            for e in heads.values():
                if e.event is not None and not e.event.query():
                    continue
                with self._lock:
                    if e.claimed:
                        continue
                    e.claimed = True
                self.bar.add(sum(blk.n_valid for _, blk in e.blocks))
