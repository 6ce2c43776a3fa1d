"""Kernel launch counts, and how a captured CUDA graph keeps them exact.

Each kernel wrapper counts its launches on its own function object:
``<wrapper>.launches``, and ``<wrapper>.launches_mma`` for those with a
tensor-core form (runtime/lockstep.py ``launch_counts`` reads them). The
counting runs in Python, where the wrapper launches. A CUDA graph breaks
that: its capture runs the Python but launches nothing, and each replay
launches the kernels but runs no Python. So:

- ``count``: the wrapper's one call where it launches. While this thread
  captures (``recording``), the launch goes into the capture's record,
  not into the counts;
- ``recording``: the record of one capture, {(wrapper, attribute): n};
- ``add``: what a replay adds, the record of its capture.

A capture thus counts nothing and every replay counts exactly the
launches the device ran. The record is per thread, so another model
launching beside a capture keeps its own counts.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()


def count(fn, mma: bool = False):
    """One launch of ``fn``'s kernel (its tensor-core form when
    ``mma``)."""
    rec = getattr(_local, "record", None)
    if rec is not None:
        rec[fn, "launches"] += 1
        if mma:
            rec[fn, "launches_mma"] += 1
        return
    fn.launches += 1
    if mma:
        fn.launches_mma += 1


@contextlib.contextmanager
def recording():
    """Divert this thread's launch counts into the returned record."""
    if getattr(_local, "record", None) is not None:
        raise RuntimeError("launch recording does not nest")
    _local.record = rec = collections.Counter()
    try:
        yield rec
    finally:
        _local.record = None


def add(record):
    """Count the launches of ``record`` (one replay of its capture)."""
    for (fn, attr), n in record.items():
        setattr(fn, attr, getattr(fn, attr) + n)

