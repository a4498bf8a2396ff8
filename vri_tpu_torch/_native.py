"""Load the shared native helper library (``native/libvri_native.so``)
once per process, safely against other processes.

``vri_tpu.runtime.native`` builds the library with ``make`` when it is
missing, and ``make`` writes the file in place: a process that loads it
while another is still writing it gets a half-written file and falls back
to numpy for its whole life.  :func:`ensure_native` holds an exclusive
``flock`` on a lock file beside the library while it builds (if needed)
and loads it, so one process builds and the others wait and find a whole
file.
"""

from __future__ import annotations

import fcntl
import os

from vri_tpu.runtime import native

LOCK_NAME = ".libvri_native.lock"


def ensure_native() -> bool:
    """Build the native library if it is missing and load it, under the
    lock; returns whether it is available."""
    lock = os.path.join(os.path.dirname(native._LIB_PATH), LOCK_NAME)
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            native.ensure_built()
            return native.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
