"""One retry policy for every client that must ride out an outage.

Before this module the repo had three ad-hoc retry loops (worker
minibatch backoff, PS async-push retry, deferred-report flush) plus a
bare ``wait_for_channel_ready`` timeout — four slightly different
bounded-budget semantics.  :class:`RetryPolicy` is the single
implementation: jittered exponential backoff, an attempt cap AND a
wall-clock deadline, per-attempt warnings, and one set of
``Timing.bump`` counters (``rpc_retry`` / ``rpc_gaveup``) so every
give-up in the system is countable the same way.

The jitter is *deterministic per policy instance* (seeded from the
policy name): retry schedules in tests and drills replay exactly, and
two policies with different names still decorrelate their backoff.
"""

import time
import zlib
import random

import grpc

from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Status codes a client may transparently retry: the server was
# unreachable, shedding, or mid-restart — NOT codes that mean "the
# request itself is wrong" (INVALID_ARGUMENT) or "the server has a
# bug" (INTERNAL, what rpc_error_guard aborts with).
TRANSIENT_RPC_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.ABORTED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
})


def is_transient_rpc_error(err):
    """True for gRPC errors worth riding out (master mid-restart, PS
    shard relaunching, transient partition)."""
    if not isinstance(err, grpc.RpcError):
        return False
    code = err.code() if callable(getattr(err, "code", None)) else None
    return code in TRANSIENT_RPC_CODES


class RetryPolicy:
    """Bounded, jittered exponential backoff.

    ``max_attempts`` and ``deadline_secs`` are BOTH budgets; whichever
    runs out first ends the retry loop (None disables that bound, but
    never both — an unbounded policy would turn an outage into a
    hang).  ``timing`` (utils.timing.Timing) receives ``rpc_retry``
    per pause and ``rpc_gaveup`` per exhausted budget; it is settable
    after construction so the owner of the reported Timing (the
    Worker) can bind it onto clients built earlier.
    """

    def __init__(
        self,
        name="rpc",
        max_attempts=None,
        deadline_secs=60.0,
        base_delay_secs=0.1,
        max_delay_secs=3.0,
        jitter=0.25,
        retryable=is_transient_rpc_error,
        timing=None,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        if max_attempts is None and deadline_secs is None:
            raise ValueError(
                "retry policy %r needs max_attempts or deadline_secs"
                % name
            )
        self.name = name
        self.max_attempts = max_attempts
        self.deadline_secs = deadline_secs
        self.base_delay_secs = base_delay_secs
        self.max_delay_secs = max_delay_secs
        self.jitter = jitter
        self.retryable = retryable
        self.timing = timing
        self._sleep = sleep
        self._clock = clock
        # Deterministic per-name jitter stream: drills and tests replay
        # the exact schedule; distinct policy names decorrelate.
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))

    def delay_secs(self, attempt):
        """Backoff before retry number ``attempt`` (0-based)."""
        base = min(
            self.base_delay_secs * (2 ** attempt), self.max_delay_secs
        )
        if self.jitter <= 0 or base <= 0:
            return base
        return base * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def _bump(self, counter):
        if self.timing is not None:
            self.timing.bump(counter)

    def pause(self, attempt):
        """Count one retry and sleep its backoff — for callers that own
        their loop structure (the worker's minibatch retry keeps its
        elastic re-rendezvous branch but delegates the budget
        bookkeeping here)."""
        self._bump("rpc_retry")
        delay = self.delay_secs(attempt)
        if delay > 0:
            self._sleep(delay)

    def call(self, fn, *args, description=None, stop=None,
             refresh=None, **kwargs):
        """Run ``fn`` riding out retryable errors until a budget runs
        out, then raise the LAST error (so callers' except clauses
        keep matching grpc.RpcError).  ``stop()`` (optional) aborts
        the ride immediately — e.g. graceful preemption.

        ``refresh()`` (optional) runs before each retry and may return
        a REPLACEMENT callable for the remaining attempts: gRPC
        channels can wedge their subchannel after the peer is
        SIGKILLed (stale connect backoff, poisoned fd), so
        outage-riding clients rebuild the channel and hand back the
        fresh stub method here."""
        what = description or getattr(fn, "__name__", "call")
        start = self._clock()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as err:  # noqa: BLE001 — classified below
                if not self.retryable(err):
                    raise
                attempt += 1
                elapsed = self._clock() - start
                delay = self.delay_secs(attempt - 1)
                out_of_attempts = (
                    self.max_attempts is not None
                    and attempt >= self.max_attempts
                )
                out_of_time = (
                    self.deadline_secs is not None
                    and elapsed + delay > self.deadline_secs
                )
                if out_of_attempts or out_of_time or (
                    stop is not None and stop()
                ):
                    self._bump("rpc_gaveup")
                    tracing.event("rpc_gaveup", policy=self.name,
                                  what=what, attempts=attempt,
                                  error=str(err)[:200])
                    logger.error(
                        "%s: %s failed after %d attempt(s) / %.1fs: %s",
                        self.name, what, attempt, elapsed, err,
                    )
                    raise
                self._bump("rpc_retry")
                # Outage-riding evidence in the flight recorder: these
                # instants inherit the caller's span context, so a
                # drill's kill window shows up INSIDE the affected
                # trace (docs/observability.md).
                tracing.event("rpc_retry", policy=self.name, what=what,
                              attempt=attempt, error=str(err)[:200])
                logger.warning(
                    "%s: %s unavailable (attempt %d, %.1fs elapsed), "
                    "retrying in %.2fs: %s",
                    self.name, what, attempt, elapsed, delay, err,
                )
                if refresh is not None:
                    try:
                        fresh = refresh()
                        if fresh is not None:
                            fn = fresh
                    except Exception as re:  # noqa: BLE001 — refresh
                        # is best-effort; keep retrying the old fn
                        logger.warning(
                            "%s: refresh before retry failed: %s",
                            self.name, re,
                        )
                if delay > 0:
                    self._sleep(delay)


def master_rpc_policy(timing=None, deadline_secs=None):
    """The outage-riding policy every master-facing client uses: long
    deadline (a master crash-restart cycle takes seconds to tens of
    seconds), short capped backoff so reconnect latency stays low.
    ``ELASTICDL_RPC_DEADLINE_SECS`` overrides the budget — drills
    shorten it so orphaned workers die promptly after a failed job."""
    import os

    if deadline_secs is None:
        deadline_secs = float(
            os.environ.get("ELASTICDL_RPC_DEADLINE_SECS", "120")
        )
    return RetryPolicy(
        name="master_rpc",
        deadline_secs=deadline_secs,
        base_delay_secs=0.2,
        max_delay_secs=3.0,
        timing=timing,
    )


def serving_probe_policy():
    """Backoff schedule for the fleet router re-probing an EJECTED
    serving replica (serving/fleet.py): jittered exponential from half
    a second to ~10 s.  Only the delay math is used — no RPC rides this
    policy — but reusing RetryPolicy keeps the jitter deterministic per
    process and decorrelated from the other policies by name, like
    every other backoff in the repo."""
    return RetryPolicy(
        name="serving_probe", max_attempts=1 << 30,
        deadline_secs=None, base_delay_secs=0.5, max_delay_secs=10.0,
    )


def ps_rpc_policy(timing=None, deadline_secs=None):
    """The outage-riding policy for worker->PS RPCs: a SIGKILLed PS
    shard is relaunched-with-restore by the master's PSManager in
    seconds, and every pull/push/prefetch must ride that window on the
    SAME port instead of killing the worker (docs/ps_recovery.md).
    Budgeted by the same ``ELASTICDL_RPC_DEADLINE_SECS`` env the master
    policy uses, so drills shorten both outage budgets at once."""
    import os

    if deadline_secs is None:
        deadline_secs = float(
            os.environ.get("ELASTICDL_RPC_DEADLINE_SECS", "120")
        )
    return RetryPolicy(
        name="ps_rpc",
        deadline_secs=deadline_secs,
        base_delay_secs=0.2,
        max_delay_secs=3.0,
        timing=timing,
    )
