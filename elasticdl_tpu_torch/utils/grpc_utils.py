"""gRPC channel/server builders with large-message options.

256 MB caps mirror the reference (elasticai_api/common/constants.py:15-20,
elasticdl/go/pkg/ps/server.go:31-34): a full dense pull of a ~90 MB model
must fit in one message.
"""

import fnmatch
import functools
import os
import random
import socket
import threading
import time
import zlib
from concurrent import futures

import grpc

from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.tensor_codec import FrameError

logger = get_logger(__name__)

MAX_MESSAGE_BYTES = 256 * 1024 * 1024


def rpc_error_guard(method):
    """Servicer-method wrapper: no raw exception escapes as UNKNOWN.

    An unhandled servicer exception reaches the worker as an opaque
    UNKNOWN status with no server-side log line — on the elastic
    control plane that becomes a silent re-rendezvous or a burned task
    retry with no diagnosis.  This wrapper logs the full traceback
    server-side and aborts the RPC with INTERNAL plus the exception
    text.  Direct in-process calls (tests pass context=None) just get
    the logged re-raise.  Enforced by elastic-lint rule EL002."""

    @functools.wraps(method)
    def wrapper(self, request, context=None):
        try:
            return method(self, request, context)
        except FrameError as e:
            # A malformed frame on the raw-frame data plane is the
            # CLIENT's fault: surface it as INVALID_ARGUMENT (the
            # HTTP-400 analog), never INTERNAL, so a hostile or
            # truncated blob reads as "your frame is bad" and the
            # server keeps serving (docs/ps_pipeline.md "Frame wire").
            logger.warning(
                "servicer %s.%s refused a bad frame: %s",
                type(self).__name__, method.__name__, e,
            )
            if context is not None:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "bad frame: %s" % e,
                )
            raise
        except Exception as e:
            logger.exception(
                "servicer %s.%s failed",
                type(self).__name__, method.__name__,
            )
            if context is not None and not isinstance(e, grpc.RpcError):
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    "%s failed: %s" % (method.__name__, e),
                )
            raise

    return wrapper

CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]


def build_channel(addr):
    channel = grpc.insecure_channel(addr, options=CHANNEL_OPTIONS)
    return channel


def wait_for_channel_ready(channel, timeout=30, deadline_secs=None,
                           description="server channel"):
    """Block until the channel is ready.

    ``timeout`` is the per-attempt wait; ``deadline_secs`` the total
    budget (default: equal to ``timeout``, i.e. the historical single
    wait).  With a longer deadline the wait is routed through the
    shared retry policy with a LOUD per-attempt log, so a fresh worker
    that comes up before a slowly-scheduled (or mid-restart) master
    keeps announcing what it is waiting for instead of dying on a bare
    FutureTimeoutError at startup."""
    from elasticdl_tpu_torch.utils.retry import RetryPolicy

    total = timeout if deadline_secs is None else deadline_secs
    policy = RetryPolicy(
        name="channel_ready",
        deadline_secs=total,
        base_delay_secs=0.0,   # the ready-wait itself is the backoff
        jitter=0.0,
        retryable=lambda e: isinstance(e, grpc.FutureTimeoutError),
    )
    policy.call(
        lambda: grpc.channel_ready_future(channel).result(
            timeout=min(timeout, total)
        ),
        description=description,
    )


def connect_to_master(channel, addr):
    """The shared fresh-client connect: wait for the master's channel
    with the loud per-attempt log, budgeted by
    ``ELASTICDL_CONNECT_DEADLINE_SECS`` (default 300 s — fresh workers
    routinely come up before a slowly-scheduled or mid-restart
    master)."""
    wait_for_channel_ready(
        channel, timeout=10,
        deadline_secs=float(os.environ.get(
            "ELASTICDL_CONNECT_DEADLINE_SECS", "300"
        )),
        description="master at %s" % addr,
    )


# -- deterministic RPC fault injection --------------------------------------

def _parse_kv(piece):
    key, sep, value = piece.partition("=")
    if not sep:
        raise ValueError("fault spec directive %r is not key=value" % piece)
    return key.strip(), value.strip()


class _FaultClause:
    """One ``pattern:directive,...`` clause of an rpc_fault_spec.

    Triggers (all optional; no trigger = every matching call):
      every=N        every Nth call (1-based: the Nth, 2Nth, ...)
      nth=N          exactly call N (with count=M: calls N..N+M-1)
      count=M        width of the nth window (default 1)
      prob=P         seeded per-(clause, method) coin
      down=A~B       wall-clock window [A, B) seconds after server start
    Actions (no action = code=UNAVAILABLE):
      delay_ms=F     sleep before handling (emulated latency)
      code=NAME      abort with that grpc.StatusCode
      blackhole=S    hold the RPC S seconds, then abort UNAVAILABLE —
                     the client sees a hung-then-dropped connection
    """

    def __init__(self, pattern, directives):
        self.pattern = pattern
        self.every = None
        self.nth = None
        self.count = 1
        self.prob = None
        self.down = None
        self.delay_secs = 0.0
        self.code = None
        self.blackhole_secs = None
        has_action = False
        for key, value in directives:
            if key == "every":
                self.every = int(value)
            elif key == "nth":
                self.nth = int(value)
            elif key == "count":
                self.count = int(value)
            elif key == "prob":
                self.prob = float(value)
            elif key == "down":
                lo, _, hi = value.partition("~")
                self.down = (float(lo), float(hi))
            elif key == "delay_ms":
                self.delay_secs = float(value) / 1000.0
                has_action = True
            elif key == "code":
                self.code = getattr(grpc.StatusCode, value.upper())
                has_action = True
            elif key == "blackhole":
                self.blackhole_secs = float(value)
                has_action = True
            else:
                raise ValueError(
                    "unknown fault spec directive %r" % key
                )
        if not has_action:
            self.code = grpc.StatusCode.UNAVAILABLE

    def matches(self, method):
        base = method.rsplit("/", 1)[-1]
        return (
            fnmatch.fnmatchcase(base, self.pattern)
            or fnmatch.fnmatchcase(method, self.pattern)
        )

    def fires(self, call_index, rng, elapsed_secs):
        """``call_index`` is 1-based per (clause, method)."""
        if self.every is not None and call_index % self.every != 0:
            return False
        if self.nth is not None and not (
            self.nth <= call_index < self.nth + self.count
        ):
            return False
        if self.down is not None and not (
            self.down[0] <= elapsed_secs < self.down[1]
        ):
            return False
        if self.prob is not None and rng.random() >= self.prob:
            return False
        return True


class FaultSpec:
    """Parsed, seedable per-method fault schedule.

    ``spec := clause (';' clause)*`` where a clause is either
    ``seed=N`` or ``pattern:directive[,directive...]`` (see
    _FaultClause).  The schedule is DETERMINISTIC: per-(clause,
    method) call counters, and a per-(seed, clause index, method) RNG
    for ``prob`` coins — the same seed + spec + per-method call
    sequence always injects the same faults, regardless of how other
    methods' traffic interleaves.  ``down=`` windows are the one
    wall-clock trigger (for drill scripting like "master unreachable
    for 5 s"); everything else replays exactly.
    """

    def __init__(self, text):
        self.text = text
        self.seed = 0
        self.clauses = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed=") and ":" not in raw:
                self.seed = int(raw.partition("=")[2])
                continue
            pattern, sep, body = raw.partition(":")
            if not sep:
                raise ValueError(
                    "fault spec clause %r lacks 'pattern:'" % raw
                )
            directives = [
                _parse_kv(p) for p in body.split(",") if p.strip()
            ]
            self.clauses.append(_FaultClause(pattern.strip(), directives))
        self._lock = threading.Lock()
        self._counters = {}   # (clause index, method) -> calls seen
        self._rngs = {}       # (clause index, method) -> Random

    @classmethod
    def parse(cls, text):
        return cls(text)

    def _rng(self, ci, method):
        key = (ci, method)
        rng = self._rngs.get(key)
        if rng is None:
            rng = random.Random(zlib.crc32(
                ("%d:%d:%s" % (self.seed, ci, method)).encode("utf-8")
            ))
            self._rngs[key] = rng
        return rng

    def decide(self, method, elapsed_secs=0.0):
        """Consume one call of ``method``; returns
        ``(delay_secs, abort_code_or_None)``.  Delays from multiple
        firing clauses accumulate; the first firing abort code wins."""
        delay = 0.0
        code = None
        with self._lock:
            for ci, clause in enumerate(self.clauses):
                if not clause.matches(method):
                    continue
                key = (ci, method)
                index = self._counters.get(key, 0) + 1
                self._counters[key] = index
                if not clause.fires(index, self._rng(ci, method),
                                    elapsed_secs):
                    continue
                delay += clause.delay_secs
                if clause.blackhole_secs is not None:
                    delay += clause.blackhole_secs
                    if code is None:
                        code = grpc.StatusCode.UNAVAILABLE
                if code is None and clause.code is not None:
                    code = clause.code
        return delay, code

    def plan(self, method, n_calls, elapsed_secs=0.0):
        """The schedule the first ``n_calls`` of ``method`` would see,
        from a FRESH copy of this spec — a pure function of (seed,
        spec text), so tests can assert determinism without driving a
        server."""
        fresh = FaultSpec(self.text)
        fresh.seed = self.seed
        return [
            fresh.decide(method, elapsed_secs=elapsed_secs)
            for _ in range(n_calls)
        ]


class FaultInjectionInterceptor(grpc.ServerInterceptor):
    """Deterministic per-method fault injection (grown from the old
    fixed-delay RpcDelayInterceptor): drills and tests script failures
    like "every 7th report_batch_done is UNAVAILABLE" or "master
    blackholed for 5 s" reproducibly via an ``--rpc_fault_spec``
    string (see FaultSpec).  Delays sleep on the handler thread, so
    concurrent RPCs are delayed concurrently — like wire latency, not
    like a slow server."""

    def __init__(self, spec, clock=time.monotonic):
        self.spec = spec if isinstance(spec, FaultSpec) else (
            FaultSpec(spec)
        )
        self._clock = clock
        self._start = clock()

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if (
            handler is None
            or not self.spec.clauses
            or handler.unary_unary is None
        ):
            return handler
        inner = handler.unary_unary
        method = handler_call_details.method

        def faulted(request, context):
            delay, code = self.spec.decide(
                method, elapsed_secs=self._clock() - self._start
            )
            if delay > 0:
                time.sleep(delay)
            if code is not None:
                logger.warning(
                    "fault injection: aborting %s with %s",
                    method, code.name,
                )
                context.abort(
                    code, "injected fault (%s)" % code.name
                )
            return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            faulted,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


class RpcDelayInterceptor(FaultInjectionInterceptor):
    """Benchmark aid: a fixed per-RPC latency emulating a cross-host
    link on a loopback rig — now the trivial case of the fault
    interceptor (an unconditional all-methods delay clause)."""

    def __init__(self, delay_s):
        self.delay_s = float(delay_s)
        spec = (
            "*:delay_ms=%g" % (self.delay_s * 1000.0)
            if self.delay_s > 0 else ""
        )
        super().__init__(spec)


class TraceServerInterceptor(grpc.ServerInterceptor):
    """Adopts the caller's trace context from gRPC metadata
    (utils/tracing.py) and runs every unary handler inside a server
    span, so servicer-side flight-recorder events (task completions,
    generation fences, checkpoint commits) land in the SAME trace as
    the worker that caused them.  Installed on every server by
    ``build_server``; a no-op passthrough when tracing is disabled."""

    def __init__(self, tracer=None):
        self._tracer = tracer or tracing.default_tracer()

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if (
            handler is None
            or handler.unary_unary is None
            or not self._tracer.enabled
        ):
            return handler
        inner = handler.unary_unary
        method = handler_call_details.method
        metadata = handler_call_details.invocation_metadata
        tracer = self._tracer

        def traced(request, context):
            with tracer.server_span(method, metadata):
                return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            traced,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def build_server(max_workers=64, interceptors=None):
    # The trace interceptor is outermost so injected faults, delays,
    # and aborts from later interceptors are visible INSIDE the span
    # (an aborted RPC records its span end with the abort error).
    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=CHANNEL_OPTIONS,
        interceptors=[TraceServerInterceptor()]
        + list(interceptors or ()),
    )


def find_free_port(host="localhost"):
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]
