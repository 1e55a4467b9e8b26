"""Builds the JAX package's native host libraries before any test runs.

``tests/test_native_parse.py`` and ``tests/test_native_hostops.py`` decide
at import whether to skip, by loading ``sequencealigner_tpu.io.native``'s
libraries.  Under pytest-xdist every worker imports every test file, so
on a cold build cache the workers would build one library at once, and
that package's loader gives up in a worker that loses the race (it
builds every process's output to one shared temporary name).  Here the
process that starts the run builds them once, before it starts any
worker, so that every worker finds them in the cache.  It does so in a
child process, which keeps ``jax`` out of the pytest process; on a host
without a C compiler the build fails as before and those tests skip.
"""

import subprocess
import sys
from pathlib import Path

BUILD = ("from sequencealigner_tpu.io import native; "
         "native.get(); native.hostops()")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    try:
        subprocess.run([sys.executable, "-c", BUILD],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, timeout=300)
    except subprocess.TimeoutExpired:
        pass  # each worker then tries on its own, as without this file
