"""Load the JAX package's native library once per test process, one process
at a time, before any other test module asks for it.

Test workers started together race to build the library: one worker's
``make`` can still be writing ``native/build/libprealps_host.so`` while
another loads it, and ``prealps_tpu/native.py`` keeps a failed load for the
life of the process. That worker's JAX partitions then run the Python
algorithm and differ from the port's native ones, so the port's tests that
hold its partitions to JAX's fail there alone.

The load happens when this module is imported. The file is named to sort
first: pytest collects a directory's files in name order, and every xdist
worker collects all of them before any test runs, so this load, under an
``flock`` on ``native/build/.load.lock``, comes before the first module that
asks for the library at import (``tests/test_native.py``'s skip mark).
"""

import fcntl
import os
import shutil

from prealps_tpu import native


def _load_under_lock() -> bool:
    build = os.path.dirname(native._SO_PATH)
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, ".load.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return native.available()


LOADED = _load_under_lock()


def test_native_library_loads_where_it_can_be_built():
    """Where ``make`` and a C++ compiler are present, this process holds the
    library: a failed load here is the race above."""
    if not (shutil.which("make") and shutil.which(os.environ.get("CXX", "g++"))):
        assert LOADED == native.available()
        return
    assert LOADED and native.available()
