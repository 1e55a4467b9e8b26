"""The card sampler parses its loop's lines, averages them over a job and
ends the process it started."""

import os
import time

from portbench.core import hostwatch

FAKE = """#!/bin/sh
while true; do
  echo "0, 1980, 400.50, 50"
  echo "1, 1755, [N/A], 48"
  sleep 0.05
done
"""


def test_the_card_sampler_reads_and_stops(tmp_path, monkeypatch):
    smi = tmp_path / "nvidia-smi"
    smi.write_text(FAKE)
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    t0 = time.perf_counter()
    with hostwatch.CardWatch(True) as watch:
        while len(watch.samples) < 3 and time.perf_counter() - t0 < 30:
            time.sleep(0.05)
        proc = watch._proc
    assert proc.poll() is not None
    assert watch.over(t0, time.perf_counter()) == {
        "sm_mhz": 1980.0, "power_w": 400.5, "temp_c": 50.0}
    assert watch.summary().startswith("card samples: ")


def test_without_nvidia_smi_the_sampler_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with hostwatch.CardWatch(True) as watch:
        pass
    assert watch.samples == [] and watch.over(0, 1e12) == {}
    assert watch.summary() == "card samples: none"
    a = hostwatch.host_now()
    sum(range(10 ** 5))
    d = hostwatch.host_delta(a, hostwatch.host_now())
    assert set(d) == {"cpu_user_s", "cpu_sys_s"} and d["cpu_user_s"] >= 0
