"""Spans of the host pipeline: wall seconds summed into a dict of timings
where the work runs, and, while a torch.profiler is recording, a
`dabmod.<name>` range on the profiler's clock beside the card's activity.

    with span(timings, "parse"):            # timings["parse_s"] += wall
        ...
    with span(timings, "issue", key="modulate"):
        ...                                 # timings["modulate_s"]

A span's key must exist in the dict before it closes (the runtime declares
every key at construction, so that a snapshot taken at any time has them
all).  With no profiler recording, a span makes no call into torch: it
reads the profiler module's Python flag, which torch.profiler sets on
start and clears on stop.  A profiler records the ranges of the threads it
was told to record (the thread that started it, unless
`profile_all_threads` is set in its experimental config)."""
from __future__ import annotations

import time

from torch.autograd import profiler as _profiler

RANGE_PREFIX = "dabmod."


class span:
    """A context manager; one object a `with`, on one thread."""

    __slots__ = ("timings", "key", "name", "_t0", "_range")

    def __init__(self, timings: dict | None, name: str, key: str | None = None):
        # timings None: the profiler range alone
        self.timings = timings
        self.name = name
        self.key = (key or name) + "_s"

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.timings is not None:
            self.timings[self.key] += t1 - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False
