"""Streaming log-bucketed latency histograms — the percentile plane.

Every latency-shaped series in the system used to be a lifetime mean
(``Timing`` totals/counts): useless reactively (the router's
autoscaler had to invent probe-differencing to recover a recent
signal) and blind to tail skew (the resize controller steered on
``steps_per_sec`` averages).  This module is the shared distribution
primitive behind all of them:

 - **Fixed bucket boundaries.**  One log-spaced boundary set
   (``BUCKET_BOUNDS``, ~10 µs → ~100 s, 3 buckets per decade) shared
   by every histogram in every process, so a cross-process merge is an
   EXACT bucket-wise sum — the worker's step-time deltas piggybacked
   on progress RPCs add into the master's per-job aggregate with no
   re-binning error, and two replicas' ``/metrics`` histograms sum in
   a scraper the way Prometheus histograms are designed to.
 - **Lock-safe streaming observe.**  ``observe`` is one bisect plus a
   few increments under a plain lock (never IO, never another lock) —
   legal on any hot path the ``Timing`` conventions already allow.
 - **Sparse deltas.**  ``delta``/``encode_deltas`` turn the difference
   between two snapshots into a compact string that rides an existing
   RPC field; ``decode_deltas``/``merge_delta`` reassemble exact
   histograms on the far side (master per-job p50/p99 step time is a
   merge of true per-worker distributions, not a mean of means).
 - **Windowed view.**  ``Histogram.recent()`` differences rotated
   snapshots at a window cadence, so a surface can report "queue wait
   over the last ~N seconds" directly instead of forcing every
   consumer to re-derive it by probe-differencing.

The histogram path has a global off-switch (``set_enabled(False)`` /
``ELASTICDL_HIST=off``) so ``bench_tracing.py`` can gate its overhead
(interleaved on/off legs, <= 2% steps/s) exactly like the tracing
plane's switch.
"""

import os
import threading
import time
from bisect import bisect_left

# One boundary set for the whole system (see module docstring): three
# log-spaced buckets per decade from 10 µs to 100 s.  22 finite upper
# bounds + the implicit +Inf bucket.  NEVER reorder or renumber —
# sparse deltas address buckets by index, and cross-process exactness
# depends on every process agreeing on this list.  Appending finer/
# coarser bounds would also break merges; change DELTA_VERSION if the
# scheme ever has to move.
BUCKET_BOUNDS = tuple(
    round(1e-5 * 10.0 ** (i / 3.0), 10) for i in range(22)
)

N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + the overflow (+Inf) bucket

# Version token carried by encoded deltas: a decoder refuses deltas
# minted against a different bucket scheme instead of mis-merging.
DELTA_VERSION = "h1"

ENV_HIST = "ELASTICDL_HIST"

_enabled = os.environ.get(ENV_HIST, "on").lower() not in (
    "off", "0", "false"
)


def hist_enabled():
    return _enabled


def set_enabled(on):
    """Flip the histogram path globally (bench on/off legs)."""
    global _enabled
    _enabled = bool(on)


def bucket_index(seconds):
    """Index of the bucket ``seconds`` falls in (last = overflow)."""
    return bisect_left(BUCKET_BOUNDS, seconds)


class Histogram:
    """One streaming histogram over the shared boundary set.

    ``observe`` is the only hot-path method; snapshots/quantiles are
    the cold readers.  All state under one plain lock (the critical
    sections are a few list/scalar ops — never IO, never another
    lock, matching the Timing thread model)."""

    __slots__ = ("_lock", "_counts", "_sum", "_count",
                 "_win_prev", "_win_prev_ts", "_win_last")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * N_BUCKETS
        self._sum = 0.0
        self._count = 0
        # Windowed view state (recent()): the previous rotated
        # snapshot, its rotation time, and the last completed window's
        # delta stats.
        self._win_prev = None
        self._win_prev_ts = None
        self._win_last = None

    def observe(self, seconds, n=1):
        """Record ``n`` observations of ``seconds`` each (bulk form:
        the fused driver observes a window's per-step time once with
        n = window size)."""
        idx = bisect_left(BUCKET_BOUNDS, seconds)
        with self._lock:
            self._counts[idx] += n
            self._sum += seconds * n
            self._count += n

    def snapshot(self):
        """Plain-dict snapshot: {"counts": [...], "sum": s,
        "count": n} — the shape every renderer/merger consumes."""
        with self._lock:
            return {"counts": list(self._counts), "sum": self._sum,
                    "count": self._count}

    def recent(self, window_secs=5.0, now=None):
        """Delta snapshot over roughly the last ``window_secs``:
        rotates an internal snapshot at window cadence and returns the
        last COMPLETED window's delta (the in-progress delta before
        the first rotation).  None until anything was observed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._count == 0 and self._win_prev is None:
                return None
            cur = {"counts": list(self._counts), "sum": self._sum,
                   "count": self._count}
            if self._win_prev is None:
                self._win_prev, self._win_prev_ts = cur, now
                return cur
            if now - self._win_prev_ts >= window_secs:
                self._win_last = _sub(cur, self._win_prev)
                self._win_prev, self._win_prev_ts = cur, now
            return (self._win_last if self._win_last is not None
                    else cur)


def _sub(cur, prev):
    return {
        "counts": [c - p for c, p in zip(cur["counts"],
                                         prev["counts"])],
        "sum": cur["sum"] - prev["sum"],
        "count": cur["count"] - prev["count"],
    }


def empty_snapshot():
    return {"counts": [0] * N_BUCKETS, "sum": 0.0, "count": 0}


def merge_into(acc, snap):
    """Exact bucket-wise sum of ``snap`` into accumulator ``acc``
    (both plain snapshot dicts; fixed shared bounds make this exact)."""
    acc["counts"] = [a + b for a, b in zip(acc["counts"],
                                           snap["counts"])]
    acc["sum"] += snap["sum"]
    acc["count"] += snap["count"]
    return acc


def delta(cur, prev):
    """Sparse difference between two snapshots of ONE histogram:
    {"sum": ds, "count": dn, "buckets": {index: dcount}} with only the
    changed buckets — the piggyback payload.  ``prev`` None means
    "everything"."""
    if prev is None:
        prev = empty_snapshot()
    buckets = {}
    for i, (c, p) in enumerate(zip(cur["counts"], prev["counts"])):
        if c != p:
            buckets[i] = c - p
    return {"sum": cur["sum"] - prev["sum"],
            "count": cur["count"] - prev["count"],
            "buckets": buckets}


def merge_delta(acc, d):
    """Apply a sparse delta to an accumulator snapshot (exact sum)."""
    for i, n in d["buckets"].items():
        acc["counts"][i] += n
    acc["sum"] += d["sum"]
    acc["count"] += d["count"]
    return acc


def quantile(snap, q):
    """Prometheus-style quantile estimate from a snapshot: find the
    bucket where the cumulative count crosses ``q * count``, linearly
    interpolate inside it.  The overflow bucket answers with the top
    finite boundary (a scraper's histogram_quantile does the same).
    None on an empty histogram."""
    total = snap["count"]
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    for i, n in enumerate(snap["counts"]):
        if n <= 0:
            continue
        if seen + n >= rank:
            if i >= len(BUCKET_BOUNDS):
                return BUCKET_BOUNDS[-1]
            lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
            hi = BUCKET_BOUNDS[i]
            frac = (rank - seen) / n
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += n
    return BUCKET_BOUNDS[-1]


def mean(snap):
    if not snap or snap["count"] <= 0:
        return None
    return snap["sum"] / snap["count"]


# -- sparse-delta wire encoding ----------------------------------------------
#
# Compact enough to ride an existing RPC string field every progress
# flush: "h1|step_time;s=1.234e-2;n=88;b=3:5,4:80,7:3|next_name;..."

def encode_deltas(deltas):
    """{name: sparse delta} -> one compact string (sorted for
    determinism); "" when every delta is empty."""
    parts = []
    for name in sorted(deltas):
        d = deltas[name]
        if not d["count"] and not d["buckets"]:
            continue
        buckets = ",".join(
            "%d:%d" % (i, d["buckets"][i]) for i in sorted(d["buckets"])
        )
        # repr round-trips the float exactly (shortest such form), so
        # decoded sums match the sender bit-for-bit.
        parts.append("%s;s=%s;n=%d;b=%s"
                     % (name, repr(float(d["sum"])), d["count"],
                        buckets))
    if not parts:
        return ""
    return DELTA_VERSION + "|" + "|".join(parts)


def decode_deltas(payload):
    """Inverse of :func:`encode_deltas`; {} on empty, unknown version
    (a worker built against a future bucket scheme), or garbage — a
    bad piggyback must never fail the progress RPC that carried it."""
    if not payload:
        return {}
    pieces = payload.split("|")
    if pieces[0] != DELTA_VERSION:
        return {}
    out = {}
    for part in pieces[1:]:
        try:
            name, s, n, b = part.split(";")
            buckets = {}
            for pair in b[2:].split(","):
                if not pair:
                    continue
                i, c = pair.split(":")
                i = int(i)
                if not 0 <= i < N_BUCKETS:
                    raise ValueError("bucket index %d" % i)
                buckets[i] = int(c)
            out[name] = {"sum": float(s[2:]), "count": int(n[2:]),
                         "buckets": buckets}
        except (ValueError, IndexError):
            return {}  # torn payload: drop whole, never half-merge
    return out
