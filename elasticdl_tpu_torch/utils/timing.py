"""Per-phase wall-clock accumulators: the part of the JAX package's
``utils/timing.py`` ``Timing`` that the trainer uses (``timeit``, read
back with ``summary``).  No event counters, histograms or profiler hooks
yet: the port's trainer counts no events.

A training thread may write phases while another thread reads a
summary; every mutation and snapshot runs under one lock.
"""

import contextlib
import threading
import time
from collections import defaultdict


class Timing:
    """Accumulates wall-clock per named phase across calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def timeit(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            seconds = time.perf_counter() - start
            with self._lock:
                self._totals[name] += seconds
                self._counts[name] += 1

    def summary(self):
        """{phase: {total_s, count, mean_s}}."""
        with self._lock:
            totals = dict(self._totals)
            counts = dict(self._counts)
        return {
            name: {
                "total_s": totals[name],
                "count": counts[name],
                "mean_s": totals[name] / max(1, counts[name]),
            }
            for name in totals
        }
