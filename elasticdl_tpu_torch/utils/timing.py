"""Per-phase timing accumulators (counterpart of
``elasticdl_tpu/utils/timing.py``; ``device_trace`` runs over
``torch.profiler`` where the JAX package runs ``jax.profiler``).

Built-in observability from day one (SURVEY.md §5.1): the reference only has
a DEBUG-level Timing helper (elasticdl/python/common/timing_utils.py:17-48);
here timing is always on, cheap, and reportable, and ``TorchProfiler``
gives device traces (Chrome-trace JSON) behind the ``start_trace(dir)`` /
``stop_trace()`` interface the JAX package's callers use on
``jax.profiler``.

Thread model: phases and counters are written by training/executor
threads while /statz, /metrics, and Timing.report() readers snapshot
concurrently.  Every mutation AND every snapshot runs under one plain
lock — the critical sections are a handful of dict operations (never
IO, never another lock), so the hot-path cost is one uncontended
acquire (~100 ns) and a reader can never observe a torn
(total bumped, count not) pair or a mid-resize dict.  The historical
``dict(list(...))`` snapshot idiom protected ``counters()``/
``summary()`` but left ``report()``/``sync_fraction`` reading live
dicts; the hammer test in tests/test_observability.py drives writers
against every snapshot path.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict

from elasticdl_tpu_torch.utils import hist as hist_mod


class Timing:
    """Accumulates wall-clock per named phase across calls.

    Behind every phase's (total, count) mean sits a streaming
    log-bucketed histogram (utils/hist.py) fed by the same
    ``observe``/``end`` calls, so any phase has a derivable p50/p99
    and a windowed recent view — globally switchable via
    ``hist.set_enabled`` / ``ELASTICDL_HIST=off`` (bench overhead
    legs)."""

    def __init__(self, enabled=True, logger=None):
        self._enabled = enabled
        self._logger = logger
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._totals = defaultdict(float)
            self._counts = defaultdict(int)
            self._starts = {}
            self._events = defaultdict(int)
            self._hists = {}


    def bump(self, name, n=1):
        """Count a discrete event (no duration) — e.g. how often an
        async gradient push actually overlapped compute vs. blocked, or
        embedding-prefetch hits vs. misses."""
        if self._enabled:
            with self._lock:
                self._events[name] += n

    def counters(self):
        with self._lock:
            return dict(self._events)

    def observe(self, name, seconds, n=1):
        """Record ``n`` already-measured durations of ``seconds`` each
        — for phases whose start and end happen on different threads
        (e.g. a serving request's queue wait: enqueued on the request
        thread, measured when the batcher executor picks it up).  The
        bulk form (n > 1) is for per-step stats derived once per fused
        window."""
        if self._enabled:
            h = None
            with self._lock:
                self._totals[name] += seconds * n
                self._counts[name] += n
                if hist_mod.hist_enabled():
                    # Get-or-create under the Timing lock (dict
                    # mutation); the observe itself runs on the
                    # histogram's own leaf lock OUTSIDE this one.
                    h = self._hists.get(name)
                    if h is None:
                        h = self._hists[name] = hist_mod.Histogram()
            if h is not None:
                h.observe(seconds, n=n)

    def start(self, name):
        if self._enabled:
            now = time.perf_counter()
            with self._lock:
                self._starts[name] = now

    def end(self, name):
        if self._enabled:
            now = time.perf_counter()
            h = seconds = None
            with self._lock:
                if name in self._starts:
                    seconds = now - self._starts.pop(name)
                    self._totals[name] += seconds
                    self._counts[name] += 1
                    if hist_mod.hist_enabled():
                        h = self._hists.get(name)
                        if h is None:
                            h = self._hists[name] = (
                                hist_mod.Histogram())
            if h is not None:
                h.observe(seconds)

    @contextlib.contextmanager
    def timeit(self, name):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    # -- histogram readers (the percentile plane) ---------------------------

    def histograms(self, names=None):
        """{phase: snapshot dict} for every phase with a histogram
        (or only ``names``) — the shape utils/prom.py renders as
        native Prometheus histograms and /statz ships raw."""
        with self._lock:
            hists = {
                name: h for name, h in self._hists.items()
                if names is None or name in names
            }
        return {name: h.snapshot() for name, h in hists.items()}

    def hist_snapshot(self, name):
        with self._lock:
            h = self._hists.get(name)
        return h.snapshot() if h is not None else None

    def percentile(self, name, q):
        """qth quantile estimate for a phase (seconds), or None."""
        snap = self.hist_snapshot(name)
        return hist_mod.quantile(snap, q) if snap else None

    def recent(self, name, window_secs=5.0, now=None):
        """Delta snapshot over roughly the last ``window_secs`` for a
        phase (see hist.Histogram.recent), or None — the direct
        windowed-load signal /statz surfaces so consumers stop
        re-deriving it by probe-differencing."""
        with self._lock:
            h = self._hists.get(name)
        return h.recent(window_secs, now=now) if h is not None else None

    def sync_fraction(self, dispatch_name, sync_name):
        """Blocked-on-device share of an async hot loop: with the fused
        driver the step enqueue is timed under ``dispatch_name``
        ("window_dispatch") and the cadence loss fetch under
        ``sync_name`` ("loss_sync"), so this is ~0 when overlap works
        and ->1 when every step stalls on the device.  None until both
        phases have samples' worth of time."""
        with self._lock:
            dispatch = self._totals.get(dispatch_name, 0.0)
            sync = self._totals.get(sync_name, 0.0)
        if dispatch + sync <= 0.0:
            return None
        return sync / (dispatch + sync)

    def summary(self):
        with self._lock:
            totals = dict(self._totals)
            counts = dict(self._counts)
            events = dict(self._events)
        out = {
            name: {
                "total_s": totals[name],
                "count": counts.get(name, 0),
                "mean_s": totals[name] / max(1, counts.get(name, 0)),
            }
            for name in totals
        }
        # ZeRO-1 section: the sharded-update byte counters
        # (reduce-scatter/all-gather payloads per step, elastic reshard
        # traffic) grouped so bench/statz consumers see them as one
        # block.  Present only when a zero1 trainer bumped them, so
        # phase-only consumers (which iterate {total_s,...} entries)
        # are unaffected elsewhere.
        zero1 = {
            name: count for name, count in events.items()
            if name.startswith("zero1_")
        }
        if zero1:
            out["zero1"] = zero1
        # Serving embedding hot-row cache counters (hits/misses/
        # evictions, serving/embedding_service.py), grouped the same
        # way for /statz and bench consumers.
        emb_cache = {
            name: count for name, count in events.items()
            if name.startswith("emb_cache.")
        }
        if emb_cache:
            out["emb_cache"] = emb_cache
        return out

    def report(self):
        if self._logger is None:
            return
        # One coherent snapshot for BOTH sections: the counter loop
        # used to iterate the live events dict and could hit a
        # concurrent writer's resize mid-report.
        summary = self.summary()
        counters = self.counters()
        for name, s in sorted(summary.items()):
            if "total_s" not in s:
                continue  # counter section (zero1), logged below
            self._logger.info(
                "timing[%s]: total=%.3fs count=%d mean=%.4fs",
                name,
                s["total_s"],
                s["count"],
                s["mean_s"],
            )
        for name, n in sorted(counters.items()):
            self._logger.info("counter[%s]: %d", name, n)


class TorchProfiler:
    """``torch.profiler`` behind ``start_trace(dir)`` / ``stop_trace()``.

    One trace at a time per process (the profiler underneath is a
    process-wide singleton): ``start_trace`` raises while a trace runs
    and leaves that trace alone.  ``stop_trace`` writes one Chrome-trace
    JSON into the directory, named by the process's role, worker id
    (its tracing rank) and pid, and returns its path.

    CUDA activity is recorded only when this process has already
    initialised CUDA (``torch.cuda.is_initialized()``): tracing a master
    that never touched the card must not create a CUDA context on it."""

    _STARTING = object()

    def __init__(self):
        self._lock = threading.Lock()
        self._prof = None
        self._dir = None
        self.last_trace = None      # path of the last trace written
        self.last_export_s = None   # seconds its export took

    def start_trace(self, log_dir):
        import torch

        with self._lock:
            if self._prof is not None:
                raise RuntimeError(
                    "a device trace is already running in this process "
                    "(into %s)" % self._dir)
            self._prof, self._dir = self._STARTING, log_dir
        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except BaseException:
            with self._lock:
                self._prof = self._dir = None
            raise
        with self._lock:
            self._prof = prof

    def stop_trace(self):
        with self._lock:
            prof, log_dir = self._prof, self._dir
            if prof is None or prof is self._STARTING:
                raise RuntimeError("no device trace is running")
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, _trace_file_name())
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            self.last_export_s = time.perf_counter() - t0
            self.last_trace = path
            return path
        finally:
            with self._lock:
                self._prof = self._dir = None


def _trace_file_name():
    """``<role>-<worker id>-<pid>.pt.trace.json`` from the process
    identity (``tracing.configure_identity``); ``proc`` and ``na`` where
    the process set none."""
    from elasticdl_tpu_torch.utils import tracing

    attrs = tracing.process_attrs()
    rank = attrs.get("rank")
    return "%s-%s-%d.pt.trace.json" % (
        attrs.get("role", "proc"), "na" if rank is None else rank,
        os.getpid())


# The process's profiler: ``device_trace`` and ``/profilez``
# (``tracing.profilez_capture``) share it, so one refuses while the
# other traces.
PROFILER = TorchProfiler()


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a device trace around a block (Chrome-trace JSON in
    ``log_dir``; ``PROFILER.last_trace`` names the file)."""
    PROFILER.start_trace(log_dir)
    try:
        yield
    finally:
        PROFILER.stop_trace()
