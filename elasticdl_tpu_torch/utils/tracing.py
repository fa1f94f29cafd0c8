"""Project-native distributed tracing + crash flight recorder.

No OpenTelemetry dependency (the image has none): a span is a pair of
structured events in a process-local ring buffer, a trace is a 64-bit
id that rides gRPC metadata (``proto/rpc.py`` injects it client-side,
``grpc_utils.TraceServerInterceptor`` adopts it server-side), so one
elastic incident — task re-queue, epoch re-form, PS restart-generation
bump, checkpoint commit, serving version barrier — is a single
causally-linked trace across master, PS shards, workers, and the
serving fleet (docs/observability.md has the span taxonomy).

Three pieces:

 - **Span API**: ``with span("worker.task", task_id=3):`` nests via a
   thread-local stack; RPCs made inside inherit the context.  The
   explicit ``start_span``/``end_span`` form exists for spans whose
   begin and end straddle statements — elastic-lint EL009 enforces
   that such spans close on every exit path (``finally``).
 - **Flight recorder**: an always-on ring buffer of events.  Recording
   is lock-cheap by design: one short critical section around a slot
   write, NEVER any IO — the blocking registry (elastic-lint EL006)
   lists only ``dump``/``to_chrome`` as blocking, so a record call is
   safe at any site, including under control-plane locks.  The ring is
   dumped to ``$ELASTICDL_TRACE_DIR`` on process exit / uncaught
   exception / SIGTERM (``arm_crash_dump``; SIGKILL by definition
   leaves no dump — the surviving processes' rings plus the restarted
   process's recovery trace reconstruct the incident, which is what
   the ``cpu_master_kill`` drill asserts), queryable live via the
   ``/tracez`` endpoint every status server exposes, and exportable as
   Chrome trace-event JSON so a whole churn drill renders in Perfetto.
 - **Trace assembly**: ``trace_components`` stitches dumped rings from
   many processes into connected incident traces.  Connectivity =
   shared trace id (metadata propagation) plus explicit ``link_trace``
   attrs — a restarted master stamps every post-replay event with a
   link to its journal-replay trace, so the worker-side outage ride
   and the master-side recovery become ONE component.

Disable with ``ELASTICDL_TRACING=off`` (the bench_tracing.py overhead
leg compares against exactly this switch).
"""

import atexit
import json
import os
import random
import signal
import sys
import threading
import time

TRACE_METADATA_KEY = "edl-trace"
SPAN_METADATA_KEY = "edl-span"
ENV_TRACE_DIR = "ELASTICDL_TRACE_DIR"
ENV_TRACING = "ELASTICDL_TRACING"

DEFAULT_CAPACITY = 16384


def _new_id():
    return "%016x" % random.getrandbits(64)


def tracing_enabled():
    return os.environ.get(ENV_TRACING, "on").lower() not in (
        "off", "0", "false"
    )


class FlightRecorder:
    """Fixed-capacity ring of event dicts.

    ``record`` is the only hot-path method: one slot write under a
    plain lock (no allocation beyond the event dict the caller built,
    no IO).  ``snapshot``/``dump``/``to_chrome`` are the cold readers;
    ``dump`` does file IO and must never run under another lock
    (elastic-lint blocking registry)."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        # no lock here: nothing else can reference a recorder that is
        # still constructing (clear() covers the concurrent re-init)
        self._buf = [None] * self._capacity
        self._n = 0

    def record(self, event):
        with self._lock:
            self._buf[self._n % self._capacity] = event
            self._n += 1

    def __len__(self):
        with self._lock:
            return min(self._n, self._capacity)

    @property
    def dropped(self):
        """Events overwritten by ring wraparound."""
        with self._lock:
            return max(0, self._n - self._capacity)

    def snapshot(self):
        """Events oldest-first (post-wraparound order preserved)."""
        with self._lock:
            n, cap = self._n, self._capacity
            if n <= cap:
                return [e for e in self._buf[:n]]
            head = n % cap
            return self._buf[head:] + self._buf[:head]

    def clear(self):
        with self._lock:
            self._buf = [None] * self._capacity
            self._n = 0

    def dump(self, path, process=None):
        """Write the ring as JSON (file IO — never call under a lock);
        atomic via rename so a crash mid-dump leaves the previous dump
        intact, not a torn file."""
        payload = {
            "process": dict(process or {}),
            "dropped": self.dropped,
            "events": self.snapshot(),
        }
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


class Span:
    """Handle for an open span (returned by ``start_span`` and by the
    ``span()`` context manager's ``__enter__``)."""

    __slots__ = ("trace", "span_id", "parent", "name", "start", "tid")

    def __init__(self, trace, span_id, parent, name, start, tid):
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self.name = name
        self.start = start
        self.tid = tid


class _SpanCtx:
    """``with tracer.span(...)`` context manager."""

    __slots__ = ("_tracer", "_name", "_attrs", "_trace", "_parent",
                 "_span")

    def __init__(self, tracer, name, attrs, trace, parent):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._trace = trace
        self._parent = parent
        self._span = None

    def __enter__(self):
        # elint: disable=EL009 -- the context-manager form itself: __exit__ is the guaranteed closer
        self._span = self._tracer.start_span(
            self._name, trace=self._trace, parent=self._parent,
            **self._attrs
        )
        return self._span

    def __exit__(self, exc_type, exc, _tb):
        self._tracer.end_span(self._span, error=exc)
        return False


class _ThreadStack(threading.local):
    def __init__(self):
        self.stack = []


class Tracer:
    """One per process normally (the module-level default); tests
    build private instances to model several processes in one."""

    def __init__(self, recorder=None, enabled=None):
        self.recorder = recorder if recorder is not None else (
            FlightRecorder()
        )
        self.enabled = tracing_enabled() if enabled is None else enabled
        # Process-wide attrs merged into every event (role, rank,
        # restart generation, link_trace).  Replaced atomically, read
        # without a lock: writers build a fresh dict and swap.
        self._attrs = {"pid": os.getpid()}
        self._local = _ThreadStack()

    # -- configuration ------------------------------------------------------

    def configure(self, **attrs):
        """Merge process attrs (``role``, ``rank``, ``generation``,
        ``restart``, ``link_trace``...) into every future event."""
        merged = dict(self._attrs)
        merged.update({k: v for k, v in attrs.items() if v is not None})
        self._attrs = merged

    @property
    def process_attrs(self):
        return dict(self._attrs)

    # -- context ------------------------------------------------------------

    def current(self):
        """(trace_id, span_id) of the innermost open span on this
        thread, or (None, None)."""
        stack = self._local.stack
        if not stack:
            return None, None
        top = stack[-1]
        return top.trace, top.span_id

    def _record(self, event):
        event.update(self._attrs)
        self.recorder.record(event)

    # -- spans --------------------------------------------------------------

    def start_span(self, name, trace=None, parent=None, **attrs):
        """Open a span and push it on this thread's stack.  Prefer the
        ``span()`` context-manager form; every ``start_span`` call
        outside a ``with`` must be paired with ``end_span`` on ALL exit
        paths (``finally``) — elastic-lint EL009 enforces this."""
        if not self.enabled:
            return None
        cur_trace, cur_span = self.current()
        trace = trace or cur_trace or _new_id()
        parent = parent if parent is not None else cur_span
        sp = Span(trace, _new_id(), parent, name, time.time(),
                  threading.get_ident())
        self._local.stack.append(sp)
        event = {"ph": "B", "ts": sp.start, "name": name,
                 "trace": trace, "span": sp.span_id, "tid": sp.tid}
        if parent:
            event["parent"] = parent
        if attrs:
            event["attrs"] = attrs
        self._record(event)
        return sp

    def end_span(self, sp, error=None):
        if sp is None or not self.enabled:
            return
        stack = self._local.stack
        if sp in stack:
            # Normal case: sp is the top; a leaked inner span is
            # force-popped with it rather than corrupting the stack.
            del stack[stack.index(sp):]
        event = {"ph": "E", "ts": time.time(), "name": sp.name,
                 "trace": sp.trace, "span": sp.span_id,
                 "tid": threading.get_ident(),
                 "dur_ms": round(1e3 * (time.time() - sp.start), 3)}
        if error is not None:
            event["error"] = repr(error)
        self._record(event)

    def span(self, name, trace=None, parent=None, **attrs):
        return _SpanCtx(self, name, attrs, trace, parent)

    def event(self, name, **attrs):
        """One instant event under the current context (or bare)."""
        if not self.enabled:
            return
        trace, span_id = self.current()
        event = {"ph": "i", "ts": time.time(), "name": name,
                 "tid": threading.get_ident()}
        if trace:
            event["trace"] = trace
            event["span"] = span_id
        if attrs:
            event["attrs"] = attrs
        self._record(event)

    # -- gRPC metadata propagation ------------------------------------------

    def inject(self, metadata=None):
        """Client side: current context appended as gRPC metadata."""
        trace, span_id = self.current()
        if trace is None:
            return metadata
        out = list(metadata or [])
        out.append((TRACE_METADATA_KEY, trace))
        out.append((SPAN_METADATA_KEY, span_id))
        return out

    @staticmethod
    def extract(metadata):
        """Server side: (trace_id, parent_span_id) or (None, None)."""
        trace = parent = None
        for key, value in metadata or ():
            lk = key.lower()
            if lk == TRACE_METADATA_KEY:
                trace = value
            elif lk == SPAN_METADATA_KEY:
                parent = value
        return trace, parent

    def server_span(self, method, metadata):
        """Span for one inbound RPC, adopting the caller's context from
        metadata (a new root trace when the caller sent none)."""
        trace, parent = self.extract(metadata)
        return self.span("rpc.server%s" % method, trace=trace,
                         parent=parent)

    # -- crash dump ---------------------------------------------------------

    def dump_path(self, trace_dir):
        role = self._attrs.get("role", "proc")
        return os.path.join(
            trace_dir, "%s-%d.trace.json" % (role, os.getpid())
        )

    def dump(self, trace_dir=None):
        """Write the ring to the trace dir (env default); returns the
        path or None when no dir is configured.  File IO — never call
        while holding a lock."""
        trace_dir = trace_dir or os.environ.get(ENV_TRACE_DIR)
        if not trace_dir:
            return None
        os.makedirs(trace_dir, exist_ok=True)
        return self.recorder.dump(
            self.dump_path(trace_dir), process=self._attrs
        )


# Module-level default tracer: the process's one recorder.
_TRACER = Tracer()


def default_tracer():
    return _TRACER


def configure(**attrs):
    _TRACER.configure(**attrs)


def configure_identity(role, rank=None, generation=None, **attrs):
    """The ONE process-identity entry point: stamps the log-line
    prefix (utils/logging) AND the tracer's process attrs from the
    same (role, rank, generation) triple, so an entrypoint cannot
    drift the two apart.  Extra ``attrs`` (restart, link_trace...) go
    to the tracer only."""
    from elasticdl_tpu_torch.utils.logging import set_process_identity

    set_process_identity(role, rank=rank, generation=generation)
    _TRACER.configure(role=role, rank=rank, generation=generation,
                      **attrs)


def span(name, **attrs):
    return _TRACER.span(name, **attrs)


def event(name, **attrs):
    _TRACER.event(name, **attrs)


def current():
    return _TRACER.current()


def inject(metadata=None):
    return _TRACER.inject(metadata)


def dump_now(trace_dir=None):
    return _TRACER.dump(trace_dir)


_armed = {"done": False}


def arm_crash_dump(trace_dir=None, tracer=None):
    """Dump the flight recorder on every exit path this process can
    observe: normal exit (atexit), uncaught exception (excepthook
    chain), SIGTERM (handler chain — the previous handler, e.g. the
    worker's graceful-preemption hook, still runs).  Call AFTER the
    process installed its own SIGTERM handler so the chain includes
    it.  No-op without a trace dir (flag or $ELASTICDL_TRACE_DIR) —
    the ring then stays memory-only, queryable via /tracez.

    Also arms SIGQUIT as a LIVE dump: ``kill -QUIT <pid>`` writes the
    ring to the trace dir and the process keeps running — the
    inspect-a-wedged-process path (a /tracez scrape needs a live HTTP
    thread; SIGQUIT needs only the signal machinery).  Chain-safe like
    the SIGTERM hook, except the default disposition (core dump) is
    deliberately NOT re-delivered — replacing "core dump" with "dump
    the ring and live" is the feature."""
    tracer = tracer or _TRACER
    trace_dir = trace_dir or os.environ.get(ENV_TRACE_DIR)
    if not trace_dir or _armed["done"] or not tracer.enabled:
        return None
    _armed["done"] = True

    def _dump(*_a):
        try:
            tracer.dump(trace_dir)
        except Exception:  # noqa: BLE001 — a failed dump must never
            # mask the exit path that triggered it
            pass

    atexit.register(_dump)

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        tracer.event("crash", error=repr(exc))
        _dump()
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook

    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            tracer.event("sigterm")
            _dump()
            if callable(prev_term):
                prev_term(signum, frame)
            elif prev_term == signal.SIG_DFL:
                # The process had the DEFAULT disposition (master,
                # router): after the dump, SIGTERM must still
                # terminate — restore the default and re-deliver, or
                # this handler would silently swallow the kill.
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            # SIG_IGN: the process chose to ignore SIGTERM; keep that.

        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread (embedded use): atexit still dumps

    try:
        prev_quit = signal.getsignal(signal.SIGQUIT)

        def on_quit(signum, frame):
            # The event+dump run OFF the signal frame: the handler
            # fires on the main thread between bytecodes — possibly
            # while the interrupted frame HOLDS the recorder lock
            # (record()/snapshot() are everywhere on the main loop) —
            # and both calls acquire that non-reentrant lock.  Dumping
            # inline would deadlock the very process this handler
            # exists to inspect alive; a daemon thread waits for the
            # interrupted frame to release it instead.
            def _quit_dump():
                tracer.event("sigquit")
                _dump()

            threading.Thread(target=_quit_dump, daemon=True,
                             name="sigquit-dump").start()
            if callable(prev_quit):
                # A process that installed its own SIGQUIT semantics
                # keeps them; we only prepend the dump.
                prev_quit(signum, frame)
            # SIG_DFL (core dump) / SIG_IGN: swallowed — the live-
            # inspection contract is "dump and keep running".

        signal.signal(signal.SIGQUIT, on_quit)
    except (ValueError, AttributeError):
        pass  # non-main thread, or a platform without SIGQUIT
    return trace_dir


# -- trace assembly ----------------------------------------------------------

def load_dumps(trace_dir):
    """Events from every ``*.trace.json`` in ``trace_dir`` merged into
    one list (each event already carries its process attrs)."""
    events = []
    if not trace_dir or not os.path.isdir(trace_dir):
        return events
    for name in sorted(os.listdir(trace_dir)):
        if not name.endswith(".trace.json"):
            continue
        try:
            with open(os.path.join(trace_dir, name)) as f:
                events.extend(json.load(f).get("events", []))
        except (OSError, ValueError):
            continue  # torn dump from a crashed process: skip loudly?
            # no — a missing ring is expected after SIGKILL
    return events


def trace_components(events):
    """Group events into causally-connected components: events sharing
    a trace id are connected, and an event whose ``link_trace`` attr
    names another trace merges the two (the restarted master's link
    from its serving spans back to its journal-replay trace).  Returns
    a list of event lists, largest first."""
    parent = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        parent.setdefault(a, a)
        parent.setdefault(b, b)
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for ev in events:
        trace = ev.get("trace")
        if not trace:
            continue
        parent.setdefault(trace, trace)
        # Process-wide links land top-level (configure(link_trace=...),
        # merged into every event); per-event links ride the attrs dict
        # (event("x", link_trace=...)) — e.g. the scheduler's handover
        # event linking a drained worker's trace to the resize decision
        # that moved it (docs/scheduler.md).  Both stitch.
        link = ev.get("link_trace") or (
            ev.get("attrs") or {}
        ).get("link_trace")
        if link:
            union(trace, link)
    groups = {}
    for ev in events:
        trace = ev.get("trace")
        if not trace:
            continue
        groups.setdefault(find(trace), []).append(ev)
    return sorted(groups.values(), key=len, reverse=True)


def to_chrome(events, default_pid=0):
    """Chrome trace-event JSON (Perfetto-loadable): B/E pairs become
    complete ``X`` events (paired by span id — cross-thread explicit
    spans still render), unclosed spans and instants render as
    instants.  ``ts`` is microseconds as the format requires."""
    begins = {}
    ends = {}
    instants = []
    for ev in events:
        ph = ev.get("ph")
        if ph == "B" and ev.get("span"):
            begins[ev["span"]] = ev
        elif ph == "E" and ev.get("span"):
            ends[ev["span"]] = ev
        else:
            instants.append(ev)

    def args_of(ev):
        args = dict(ev.get("attrs") or {})
        for key in ("trace", "span", "parent", "role", "rank",
                    "generation", "restart", "error", "link_trace"):
            if key in ev:
                args[key] = ev[key]
        return args

    out = []
    for span_id, b in begins.items():
        e = ends.get(span_id)
        row = {
            "name": b["name"],
            "pid": b.get("pid", default_pid),
            "tid": b.get("tid", 0),
            "ts": round(b["ts"] * 1e6, 1),
            "args": args_of(b),
        }
        if e is not None:
            row["ph"] = "X"
            row["dur"] = max(0.0, round((e["ts"] - b["ts"]) * 1e6, 1))
            if "error" in e:
                row["args"]["error"] = e["error"]
        else:
            row["ph"] = "i"
            row["s"] = "t"
            row["args"]["unclosed"] = True
        out.append(row)
    for span_id, e in ends.items():
        if span_id not in begins:
            # begin fell off the ring: keep the end as an instant so
            # the duration loss is visible, not silent
            instants.append(e)
    for ev in instants:
        out.append({
            "name": ev.get("name", "?"),
            "ph": "i", "s": "t",
            "pid": ev.get("pid", default_pid),
            "tid": ev.get("tid", 0),
            "ts": round(ev.get("ts", 0.0) * 1e6, 1),
            "args": args_of(ev),
        })
    out.sort(key=lambda row: row["ts"])
    return {"traceEvents": out}


def tracez_payload(fmt=None, tracer=None):
    """The ``/tracez`` endpoint body (shared by every status server):
    live ring snapshot as JSON, or Chrome trace-event format with
    ``?fmt=chrome``."""
    tracer = tracer or _TRACER
    events = tracer.recorder.snapshot()
    if fmt == "chrome":
        return to_chrome(events)
    return {
        "process": tracer.process_attrs,
        "enabled": tracer.enabled,
        "dropped": tracer.recorder.dropped,
        "events": events,
    }


def tracez_body(path, tracer=None):
    """Shared /tracez HTTP responder body: ``path`` is the raw request
    path; the one recognized query parameter is ``fmt=chrome``.  Every
    status surface (master, PS, serving replica, router) serves this
    so the trace-query API is identical across tiers."""
    import urllib.parse

    query = urllib.parse.urlparse(path).query
    fmt = urllib.parse.parse_qs(query).get("fmt", [None])[0]
    return json.dumps(tracez_payload(fmt=fmt, tracer=tracer))


def is_tracez_path(path):
    return path.split("?", 1)[0] == "/tracez"


# -- /profilez: jax.profiler capture on demand --------------------------------

# One capture at a time per process (jax.profiler is a process-global
# singleton); the flag flip is the only thing under the lock — the
# capture itself (a sleep) runs outside every lock.
_PROFILE_MAX_SECS = 60.0
_profile_lock = threading.Lock()
_profile_state = {"active": False, "captures": 0}


def profilez_capture(secs, trace_dir=None, profiler=None,
                     tracer=None):
    """Capture a device/host profile for ``secs`` seconds into the
    trace dir; returns a JSON-able result dict.  The capture directory
    and the current trace id are stamped on a ``profile.capture``
    flight-recorder event, so a Perfetto profile links back to the
    /tracez trace that requested it (docs/observability.md).

    ``profiler`` is an object with ``start_trace(dir)`` and
    ``stop_trace()``.  The JAX package defaults it to ``jax.profiler``;
    the port has no default yet (ROADMAP A15, a ``torch.profiler``
    adapter), so a call without one raises.  Past that check a
    missing/failing backend returns an error dict, never raises — this
    runs on status-server request threads."""
    if profiler is None:
        raise NotImplementedError(
            "profilez_capture needs a profiler: the port has no default "
            "device profiler yet (ROADMAP A15)")
    tracer = tracer or _TRACER
    secs = max(0.0, min(float(secs), _PROFILE_MAX_SECS))
    with _profile_lock:
        if _profile_state["active"]:
            return {"ok": False,
                    "error": "a profile capture is already running"}
        _profile_state["active"] = True
        _profile_state["captures"] += 1
        n = _profile_state["captures"]
    try:
        base = trace_dir or os.environ.get(ENV_TRACE_DIR) or "/tmp"
        role = tracer.process_attrs.get("role", "proc")
        out_dir = os.path.join(
            base, "profile-%s-%d-%d" % (role, os.getpid(), n))
        os.makedirs(out_dir, exist_ok=True)
        trace_id, span_id = tracer.current()
        tracer.event("profile.capture", dir=out_dir, secs=secs)
        profiler.start_trace(out_dir)
        try:
            time.sleep(secs)
        finally:
            profiler.stop_trace()
        return {"ok": True, "dir": out_dir, "secs": secs,
                "trace": trace_id,
                "process": tracer.process_attrs}
    except Exception as e:  # noqa: BLE001 — profiling is best-effort
        # observability; a backend without profiler support answers
        # with the error instead of a dropped connection
        return {"ok": False, "error": "%s: %s" % (type(e).__name__, e)}
    finally:
        with _profile_lock:
            _profile_state["active"] = False


def profilez_body(path, trace_dir=None, profiler=None, tracer=None):
    """Shared /profilez?secs=N HTTP responder body.  Blocks the
    calling request thread for the capture duration (ThreadingHTTP
    servers everywhere — other endpoints keep answering)."""
    import urllib.parse

    query = urllib.parse.urlparse(path).query
    raw = urllib.parse.parse_qs(query).get("secs", ["2"])[0]
    try:
        secs = float(raw)
    except ValueError:
        return json.dumps({"ok": False,
                           "error": "bad secs=%r" % raw})
    return json.dumps(profilez_capture(
        secs, trace_dir=trace_dir, profiler=profiler, tracer=tracer))


def is_profilez_path(path):
    return path.split("?", 1)[0] == "/profilez"
