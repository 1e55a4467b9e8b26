"""What the host and the cards did while the window ran, logged beside the
jobs so that a run's spread can be read against it.

- Per job, the process's CPU seconds (user and system): a job that takes
  longer for the same work shows whether the process did more (threads
  spinning, page faults in the kernel) or waited.
- Over the window, one ``nvidia-smi`` loop samples each card's SM clock,
  power draw and temperature every half second; per job, the mean over
  the samples inside the job.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time

CARD_FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")
CARD_KEYS = ("sm_mhz", "power_w", "temp_c")
PERIOD_MS = 500


def host_now() -> tuple:
    t = os.times()
    return t.user, t.system


def host_delta(a: tuple, b: tuple) -> dict:
    return {"cpu_user_s": round(b[0] - a[0], 3),
            "cpu_sys_s": round(b[1] - a[1], 3)}


class CardWatch:
    """One ``nvidia-smi`` loop over the window; a no-op where it cannot
    start.  The process is ended and waited for on exit."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        # (perf_counter, card, sm_mhz, power_w, temp_c)
        self.samples: list = []
        self._proc = None
        self._thread = None

    def __enter__(self):
        if not self.enabled:
            return self
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=index," + ",".join(CARD_FIELDS),
                 "--format=csv,noheader,nounits", f"-lms={PERIOD_MS}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None
            return self
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self):
        for line in self._proc.stdout:
            t = time.perf_counter()
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 1 + len(CARD_FIELDS):
                continue
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                continue
            self.samples.append((t, int(vals[0]), *vals[1:]))

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._thread.join(timeout=10)
            self._proc.stdout.close()
            self._proc = None
        return False

    def over(self, t0: float, t1: float) -> dict:
        """Mean of each field over the samples in [t0, t1], all cards."""
        xs = [s for s in self.samples if t0 <= s[0] <= t1]
        if not xs:
            return {}
        return {k: round(sum(s[2 + n] for s in xs) / len(xs), 1)
                for n, k in enumerate(CARD_KEYS)}

    def summary(self) -> str:
        if not self.samples:
            return "card samples: none"
        parts = []
        for n, k in enumerate(CARD_KEYS):
            v = sorted(s[2 + n] for s in self.samples)
            parts.append(f"{k} {v[0]}-{v[-1]} (median {v[len(v) // 2]})")
        return f"card samples: {len(self.samples)}; " + ", ".join(parts)
