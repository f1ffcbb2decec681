"""tpukk's native host library, built whole before any test uses it.

``tpukk.native`` compiles ``libtpukk_native.so`` in place (``g++ -o``) when
the file is missing or older than its source.  Under pytest-xdist every
worker may do so at once, and a worker that loads the file while another is
still writing it keeps ``None`` for the rest of its life: its callers then
fall back to their Python versions, and the tests that hold the port to
``tpukk`` compare against another route, or fail.

This module runs at collection, which every xdist worker finishes before any
test is scheduled.  It builds the library with ``tpukk``'s own flags under a
name unique to the process, in the same directory, and renames it into place
(``os.replace``), so no process loads a half-written file; and it lets a
process whose load already failed try again at its next call.  The test
below fails loudly where the library still does not load, instead of letting
a silent fallback shift the comparisons.
"""
import os
import subprocess

from tpukk import native

# tpukk/native/__init__.py's own command, with the output renamed
GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]


def _stale(so: str, src: str) -> bool:
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def prebuild_native() -> None:
    """Build ``libtpukk_native.so`` where it is missing or stale, whole, then
    clear a failed load of this process so that the next call retries."""
    so, src = native._SO, native._SRC
    if _stale(so, src):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run([*GXX, "-o", tmp, src], check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            pass  # no toolchain: the test below reports it
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    with native._lock:
        if native._tried and native._lib is None:
            native._tried = False


prebuild_native()


def test_native_library_loads():
    assert native.available(), "tpukk's native host library did not load"
