# Copy of sequencealigner_tpu/ui.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Terminal UX: headers/sections, bullet hierarchy, verbosity tiers,
interactive prompts, and progress bars.

Mirrors the observable behavior of the reference's clix print/progress layer
(reference third_party/clix/print.h, progress.h): -V verbose / -Q quiet /
-D no-detail tiers, -F force-proceed auto-answers every yes/no prompt
(print.h:585-608), -P disables progress bars, and non-TTY output degrades to
plain lines (print.h:537-543).
"""

from __future__ import annotations

import shutil
import sys
import threading
import time


class _State:
    quiet = False
    verbose = False
    no_detail = False
    force = False
    no_progress = False

    @staticmethod
    def tty() -> bool:
        return sys.stdout.isatty()


state = _State()


def configure(*, quiet=None, verbose=None, no_detail=None, force=None, no_progress=None):
    for k, v in (
        ("quiet", quiet),
        ("verbose", verbose),
        ("no_detail", no_detail),
        ("force", force),
        ("no_progress", no_progress),
    ):
        if v is not None:
            setattr(state, k, v)


def _emit(prefix: str, msg: str) -> None:
    print(f"{prefix}{msg}", flush=True)


def pheader(title: str) -> None:
    if state.quiet:
        return
    width = max(len(title) + 4, 40)
    if state.tty():
        print("┌" + "─" * (width - 2) + "┐")
        print("│" + title.center(width - 2) + "│")
        print("└" + "─" * (width - 2) + "┘")
    else:
        _emit("== ", title)


def psection(title: str) -> None:
    if state.quiet:
        return
    if state.tty():
        print(f"\n─── {title} " + "─" * max(0, 34 - len(title)))
    else:
        _emit("-- ", title)


def pinfo(msg: str, *args) -> None:
    if not state.quiet:
        _emit("• ", msg % args if args else msg)


def pinfom(msg: str, *args) -> None:
    if not state.quiet and not state.no_detail:
        _emit("  ├ ", msg % args if args else msg)


def pinfol(msg: str, *args) -> None:
    if not state.quiet and not state.no_detail:
        _emit("  └ ", msg % args if args else msg)


def pwarn(msg: str, *args) -> None:
    if not state.quiet:  # -Q suppresses all non-error printing
        _emit("! ", msg % args if args else msg)


def pwarnm(msg: str, *args) -> None:
    if not state.quiet and not state.no_detail:
        _emit("  ! ", msg % args if args else msg)


def perr(msg: str, *args) -> None:
    print(f"✗ {msg % args if args else msg}", file=sys.stderr, flush=True)


def pverb(msg: str, *args) -> None:
    if state.verbose and not state.quiet:
        _emit("· ", msg % args if args else msg)


def pverbm(msg: str, *args) -> None:
    if state.verbose and not state.quiet and not state.no_detail:
        _emit("  · ", msg % args if args else msg)


def pverbl(msg: str, *args) -> None:
    pverbm(msg, *args)


def _read_answer(prompt: str) -> str | None:
    """Read one prompt answer from stdin.  Like the reference's
    terminal_read_input (print.h:549-583), this reads stdin even when it is a
    pipe, so ``echo y | seqalign-tpu ...`` drives prompts headlessly; only a
    CLOSED/exhausted stdin yields None (caller applies the default)."""
    try:
        return input(prompt).strip()
    except EOFError:
        return None


def print_yN(prompt: str) -> bool:
    """Default-no confirm; -F forces True (print.h:585-593)."""
    if state.force:
        return True
    ans = _read_answer(f"{prompt} [y/N] ")
    return ans is not None and ans[:1].lower() == "y"


def print_Yn(prompt: str) -> bool:
    """Default-yes confirm; -F forces True (print.h:595-603)."""
    if state.force:
        return True
    ans = _read_answer(f"{prompt} [Y/n] ")
    return ans is None or ans[:1].lower() != "n"


def pchoice(options: list[str], prompt: str) -> int:
    """Numbered chooser.  Unlike yes/no prompts, the reference does NOT
    auto-answer these under -F; answers may come from a pipe
    (``printf '2\\n' | seqalign-tpu ...``), and an exhausted stdin fails
    rather than blocking."""
    for i, opt in enumerate(options):
        print(f"  [{i}] {opt}")
    while True:
        ans = _read_answer(f"{prompt}: ")
        if ans is None:
            raise RuntimeError(
                "interactive choice required but stdin is exhausted "
                f"({prompt}; options: {', '.join(options)})"
            )
        if ans.isdigit() and 0 <= int(ans) < len(options):
            return int(ans)
        if not sys.stdin.isatty():
            raise RuntimeError(
                f"invalid piped answer {ans!r} for choice prompt ({prompt})"
            )


class Progress:
    """Monitored progress bar for long phases (clix progress.h lifecycle:
    start/add/flush/end).  Thread-safe increments, periodic redraw, disabled by
    -P or quiet mode, plain-line degradation off-TTY."""

    def __init__(self, total: int, label: str):
        self.total = max(int(total), 1)
        self.label = label
        self.count = 0
        self._lock = threading.Lock()
        self._last_draw = 0.0
        self._enabled = not (state.no_progress or state.quiet) and self.total > 1
        self._tty = state.tty()
        self._done_announced = False

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            now = time.monotonic()
            if self._enabled and now - self._last_draw >= 0.25:
                self._last_draw = now
                self._draw()

    def _draw(self) -> None:
        frac = min(self.count / self.total, 1.0)
        if self._tty:
            cols = shutil.get_terminal_size().columns
            barw = max(10, min(40, cols - len(self.label) - 12))
            filled = int(barw * frac)
            sys.stdout.write(
                f"\r{self.label}: [{'█' * filled}{' ' * (barw - filled)}] {frac * 100:5.1f}%"
            )
            sys.stdout.flush()
        else:
            pct = int(frac * 100)
            if pct >= self._last_pct_line + 10 if hasattr(self, "_last_pct_line") else True:
                self._last_pct_line = pct
                print(f"{self.label}: {pct}%", flush=True)

    def end(self) -> None:
        if self._enabled and self._tty:
            self._draw()
            sys.stdout.write("\n")
            sys.stdout.flush()
