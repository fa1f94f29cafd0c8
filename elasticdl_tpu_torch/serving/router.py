"""Serving-fleet router: one front door over N replicated model servers.

PR 3 made ONE server fast (dynamic batching); this spreads
``:predict``/``:lookup`` over a fleet of them — the missing piece of
"serving heavy traffic from millions of users" (ROADMAP item 4).  The
router is a stdlib-only HTTP process (the same ThreadingHTTPServer
discipline as the model server) that owns three jobs:

 - **Routing.**  Requests carrying a key (an ``X-Routing-Key`` header,
   the frame header's ``routing_key`` on binary bodies, a
   ``routing_key`` JSON field, or — for ``:lookup`` — the embedding
   table name) are placed by RENDEZVOUS (highest-random-weight)
   hashing over the routable replicas: adding or removing a replica
   moves only ~1/N of the keyspace (tests pin this), which is what
   keeps the replicas' hot-row embedding caches warm through churn.
   Binary bodies cost the router exactly one preamble+header read —
   the payload is forwarded byte-identically, never parsed or
   re-encoded (docs/serving.md "Wire protocol").  Keyless requests
   fall back to LEAST-LOADED: the router's own live in-flight count
   per replica first (exact and instant), then the probed queue-wait
   / occupancy from each replica's ``/statz``.

 - **Health.**  A prober thread (serving/fleet.py) polls every
   replica's ``/statz``; a miss — or a failed live forward — EJECTS
   the replica, and jittered-backoff probes ride it back in.  A
   forward that fails on a dead socket is retried on a surviving
   replica EXACTLY ONCE (the retry is re-keyed over the survivors, so
   rendezvous keys fail over deterministically).

 - **Fleet hot-swap.**  The embedded FleetCoordinator rolls new export
   versions out with no mixed-version window: pre-warm everywhere,
   all-N-ready, then flip behind this router's admission gate
   (serving/fleet.py has the full protocol).  Responses carry the
   ``model_version`` that served them, so version purity is checkable
   from the outside — the bench drills do exactly that.

Observability: ``/statz`` (fleet JSON), ``/metrics`` (Prometheus, the
master status-server convention), ``/fleet/status`` (committed version
+ per-replica view — also what a rejoining replica's operator reads
instead of trusting its local disk scan).

Run:
  python -m elasticdl_tpu_torch.serving.router --replicas h:p,h:p,...
      [--export_dir BASE] [--port 8500] [--probe_interval 0.5]
"""

import http.client
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from elasticdl_tpu_torch.serving.fleet import (
    FleetCoordinator,
    FleetState,
    HealthProber,
    canary_slice,
    pick_replica,
    rendezvous_rank,
)
from elasticdl_tpu_torch.utils import slo as slo_mod
from elasticdl_tpu_torch.utils import tensor_codec
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.args import build_router_parser
from elasticdl_tpu_torch.utils.hist import Histogram
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.prom import fleet_to_prometheus

__all__ = [
    "AdmissionGate", "Router", "build_router_server", "main",
    "pick_replica", "rendezvous_rank",
]

logger = get_logger(__name__)

# Transport-level failures worth one failover retry: the replica died
# or went away mid-request.  HTTP status codes are NOT here — a 4xx/5xx
# is a replica ANSWERING, and replaying a request the replica may have
# half-executed is the client's call, not the router's.
_FORWARD_ERRORS = (ConnectionError, TimeoutError, OSError,
                   http.client.HTTPException)


class AdmissionGate:
    """The router's version-flip barrier: normally open (requests pass
    with one Event check), closed for the milliseconds of a fleet
    commit so stale-version requests DRAIN instead of interleaving
    with the new version.  Entering is (gate check + in-flight
    increment) atomically under the lock, so ``wait_idle`` can never
    miss a request that slipped past a closing gate."""

    def __init__(self):
        self._open = threading.Event()
        self._open.set()
        self._lock = threading.Lock()
        self._inflight = 0

    def enter(self, timeout=10.0):
        """True = admitted (caller MUST pair with ``exit_``); False =
        the gate stayed closed for ``timeout`` (reply 503)."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._open.wait(remaining):
                return False
            with self._lock:
                if self._open.is_set():
                    self._inflight += 1
                    return True
            # closed between wait() and the lock — wait again

    def exit_(self):
        with self._lock:
            self._inflight -= 1

    def inflight(self):
        with self._lock:
            return self._inflight

    @property
    def is_open(self):
        return self._open.is_set()

    def close(self):
        with self._lock:
            self._open.clear()

    def open(self):
        self._open.set()

    def wait_idle(self, timeout):
        deadline = time.monotonic() + timeout
        while True:
            if self.inflight() <= 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)


class _ConnPool:
    """Keep-alive connections to ONE replica.  http.client connections
    are not thread-safe, so each is used by one request at a time:
    acquire pops an idle one (or dials), release returns it.  Anything
    suspect — error, close header — is closed, not pooled."""

    def __init__(self, addr, timeout, max_idle=8):
        host, _, port = addr.rpartition(":")
        self._host = host or addr
        self._port = int(port)
        self._timeout = timeout
        self._max_idle = max_idle
        self._lock = threading.Lock()
        self._idle = []

    def acquire(self):
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self._timeout)

    def release(self, conn, reusable):
        if reusable:
            with self._lock:
                if len(self._idle) < self._max_idle:
                    self._idle.append(conn)
                    return
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — already broken
            pass

    def clear(self):
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass


class Router:
    """Routing + forwarding engine; build_router_server wraps it in the
    HTTP front end and main() adds the prober/rollout threads."""

    def __init__(self, replica_addrs, export_dir="",
                 probe_interval=0.5, probe_timeout=2.0,
                 request_timeout=60.0, barrier_timeout=120.0,
                 poll_interval=2.0, auto_rollout=True):
        self.state = FleetState(replica_addrs,
                                probe_interval=probe_interval)
        self.gate = AdmissionGate()
        self.prober = HealthProber(self.state,
                                   probe_timeout=probe_timeout)
        self.coordinator = FleetCoordinator(
            self.state, export_dir, gate=self.gate,
            http_timeout=probe_timeout,
            barrier_timeout=barrier_timeout)
        self.poll_interval = poll_interval
        self.request_timeout = request_timeout
        # How long a forward waits out an EMPTY routable set before
        # 503ing: rides probe-timeout ejection blips and whole-fleet
        # flip instants (>= one probe interval, so a healthy replica's
        # next probe readmits it inside the grace).
        self.no_replica_grace = max(2 * probe_interval, 1.0)
        # Routing-only mode (no export base to scan): there is no
        # committed version to pin routing to — any healthy replica is
        # routable, whatever it serves.  With coordination ON, routing
        # is version-pinned to the coordinator's committed version.
        self.coordinating = bool(export_dir)
        # auto_rollout=False: the scan loop only seeds + heals; every
        # rollout arrives via /fleet/rollout (the aggregation tier is
        # the one rollout minter — docs/serving.md "The online loop").
        self.auto_rollout = bool(auto_rollout)
        self._pools = {addr: _ConnPool(addr, request_timeout)
                       for addr in replica_addrs}
        self._stop = threading.Event()
        # Control commands (external rollout, canary start / promote /
        # rollback) execute ON the rollout thread via this queue: one
        # thread owns every coordinator interaction, so commands
        # serialize with scan ticks without any lock being held across
        # the barrier's blocking HTTP/sleep work.
        self._commands = queue.Queue()
        # Canary state, written ONLY by the rollout thread, read
        # per-request as one GIL-atomic tuple:
        # (version, fraction, frozenset(addrs)) or None.
        self._canary = None
        # Per-cohort series for /metrics: requests, keyed share,
        # errors, latency — many request threads bump, so guarded.
        self._cohort_lock = threading.Lock()
        self._cohorts = {c: {"requests": 0, "keyed_requests": 0,
                             "errors": 0, "latency_ms_sum": 0.0,
                             "model_version": 0}
                         for c in ("baseline", "canary")}
        # Latency DISTRIBUTIONS (utils/hist.py; /metrics renders them
        # as native Prometheus histograms): per cohort — the promote/
        # rollback evidence as a real p99 — and per replica (the
        # router-side tail view of each backend).  Histograms carry
        # their own locks; the dict of per-replica ones gets a plain
        # guard (request threads mint entries on first forward).
        self._cohort_lat = {c: Histogram()
                            for c in ("baseline", "canary")}
        self._replica_lat_lock = threading.Lock()
        self._replica_lat = {}
        # Last aggregation-tier report (freshness SLO telemetry),
        # attached by /fleet/rollout / /fleet/canary posts.
        self._agg = None
        self._rollout_thread = threading.Thread(
            target=self._rollout_loop, daemon=True,
            name="fleet-rollout")

    # -- lifecycle -----------------------------------------------------

    def start(self, coordinate=None):
        if coordinate is not None:
            self.coordinating = bool(coordinate)
        self.prober.start()
        if self.coordinating:
            self._rollout_thread.start()

    def committed_view(self):
        """The version routing pins to: the coordinator's committed
        version, or None in routing-only mode (no version discipline
        to enforce — the operator owns replica versions)."""
        return (self.coordinator.committed_version
                if self.coordinating else None)

    def stop(self):
        self._stop.set()
        self.prober.stop()
        if self._rollout_thread.is_alive():
            self._rollout_thread.join(timeout=5)
        for pool in self._pools.values():
            pool.clear()

    def _rollout_loop(self):
        while not self._stop.is_set():
            try:
                cmd = self._commands.get(timeout=self.poll_interval)
            except queue.Empty:
                cmd = None
            if self._stop.is_set():
                if cmd is not None:
                    cmd[3]["result"] = {"error": "router stopping"}
                    cmd[2].set()
                break
            try:
                if cmd is not None:
                    self._handle_command(cmd)
                else:
                    # A live canary suspends the version scan: exactly
                    # one rollout authority at a time (seed/heal keep
                    # running either way).
                    self.coordinator.tick(
                        scan=self.auto_rollout and self._canary is None)
            except Exception as e:  # noqa: BLE001 — a failed scan or
                # rollout attempt must not kill the coordinator; the
                # next tick retries
                logger.warning("fleet tick failed: %s", e)

    # -- external fleet control (the aggregation tier's surface) -------

    def _command(self, op, payload, timeout=600.0):
        """Run one control command ON the rollout thread; block the
        caller (an HTTP handler thread or the aggregation tier in
        process) until it completed.  Fails fast when there IS no
        rollout thread (routing-only mode never starts one — a queued
        command would otherwise wait out the full timeout unserved)."""
        if not self._rollout_thread.is_alive():
            return {"error": "router has no rollout coordination "
                             "(routing-only mode; start with "
                             "--export_dir)"}
        done = threading.Event()
        box = {}
        self._commands.put((op, payload, done, box))
        if not done.wait(timeout):
            return {"error": "timed out waiting for %s" % op}
        return box.get("result", {"error": "no result"})

    def _handle_command(self, cmd):
        op, payload, done, box = cmd
        try:
            handler = {
                "rollout": self._cmd_rollout,
                "canary_start": self._cmd_canary_start,
                "canary_promote": self._cmd_canary_promote,
                "canary_rollback": self._cmd_canary_rollback,
            }[op]
            box["result"] = handler(payload)
        except Exception as e:  # noqa: BLE001 — the caller gets the
            # failure as data; the loop survives
            logger.warning("fleet command %s failed: %s", op, e)
            box["result"] = {"error": "%s: %s" % (type(e).__name__, e)}
        finally:
            done.set()

    def _note_agg(self, payload):
        freshness = payload.get("freshness_seconds")
        if freshness is not None:
            self._agg = {"freshness_seconds": float(freshness),
                         "version": int(payload.get("version", 0)),
                         "at": time.time()}

    def _cmd_rollout(self, payload):
        """POST /fleet/rollout — one published version through the
        full prepare→warm→barrier→commit protocol."""
        version = int(payload["version"])
        self._note_agg(payload)
        if self._canary is not None:
            return {"committed": False,
                    "error": "canary active (version %d); promote or "
                             "roll back first" % self._canary[0],
                    "committed_version":
                        self.coordinator.committed_version}
        if not self.coordinator.seeded:
            self.coordinator.seed_committed()
        committed = self.coordinator.committed_version
        if version <= committed:
            return {"committed": version == committed,
                    "error": None if version == committed else
                    "version %d behind committed %d" % (version,
                                                        committed),
                    "committed_version": committed}
        ok = self.coordinator.rollout(version)
        return {"committed": bool(ok),
                "committed_version": self.coordinator.committed_version}

    def _cmd_canary_start(self, payload):
        """POST /fleet/canary — slice ``fraction`` of the key ring
        onto canary replicas serving ``version``: pick ceil(p*N)
        healthy replicas (always leaving >= 1 baseline), push them to
        the canary version (per-replica prepare→warm→commit, no gate —
        they are unroutable for baseline traffic the moment their
        version diverges), then publish the canary tuple to routing."""
        version = int(payload["version"])
        fraction = float(payload.get("fraction", 0.1))
        self._note_agg(payload)
        if not self.coordinating:
            # Routing-only mode has no committed version: promote has
            # nothing to barrier against and rollback would push the
            # canary replicas toward version 0 — both undefined.
            return {"started": False,
                    "error": "canary needs rollout coordination "
                             "(--export_dir)"}
        if not 0.0 < fraction < 1.0:
            return {"started": False,
                    "error": "fraction must be in (0, 1)"}
        if self._canary is not None:
            return {"started": False,
                    "error": "canary already active (version %d)"
                             % self._canary[0]}
        committed = self.coordinator.committed_version
        if version <= committed:
            return {"started": False,
                    "error": "version %d not ahead of committed %d"
                             % (version, committed)}
        routable = sorted(self.state.routable(
            committed if self.coordinating else None))
        want = min(len(routable) - 1,
                   max(1, math.ceil(fraction * len(routable))))
        if want < 1:
            return {"started": False,
                    "error": "need >= 2 routable replicas for a "
                             "canary (have %d)" % len(routable)}
        chosen = payload.get("replicas")
        if chosen:
            # Operator-supplied list rides the same safety rails as
            # the automatic pick: members of the routable set only,
            # and at least one baseline replica must remain or every
            # non-canary request 503s for the whole soak.
            unknown = sorted(set(chosen) - set(routable))
            if unknown:
                return {"started": False,
                        "error": "replicas %s are not routable"
                                 % unknown}
            if len(set(chosen)) >= len(routable):
                return {"started": False,
                        "error": "canary must leave >= 1 baseline "
                                 "replica"}
        else:
            chosen = routable[-want:]
        with tracing.span("router.canary", action="start",
                          version=version, fraction=fraction,
                          replicas=len(chosen)):
            pushed = [addr for addr in chosen
                      if self.coordinator.push_version(addr, version)]
            if not pushed:
                return {"started": False,
                        "error": "no replica accepted canary version "
                                 "%d" % version}
            self._canary = (version, fraction, frozenset(pushed))
        self.state.bump("router.canary_started")
        logger.info("canary started: version %d on %s (%.0f%% of the "
                    "key ring)", version, sorted(pushed),
                    100 * fraction)
        return {"started": True, "version": version,
                "fraction": fraction, "replicas": sorted(pushed)}

    def _cmd_canary_promote(self, _payload):
        """POST /fleet/canary/promote — the canary version goes
        fleet-wide through the normal barrier (canary replicas are
        already warm at it; their commit is idempotent), then the
        canary slice dissolves: baseline keys flip atomically behind
        the gate, canary keys keep the version they already saw."""
        canary = self._canary
        if canary is None:
            return {"promoted": False, "error": "no canary active"}
        version = canary[0]
        with tracing.span("router.canary", action="promote",
                          version=version):
            ok = self.coordinator.rollout(version)
            if ok:
                self._canary = None
                self.state.bump("router.canary_promoted")
        logger.info("canary promote of %d: %s", version,
                    "ok" if ok else "FAILED (canary still active)")
        return {"promoted": bool(ok),
                "committed_version": self.coordinator.committed_version}

    def _cmd_canary_rollback(self, _payload):
        """POST /fleet/canary/rollback — push every canary replica
        back DOWN to the committed version (the one deliberate
        regression path; replica-side refusal is waived via the
        rollback flag) and dissolve the slice.  Canary-slice keys
        return to the baseline version: a rollback is exactly the
        judgment that the canary version must stop serving, so their
        version regression is the point, not an accident."""
        canary = self._canary
        if canary is None:
            return {"rolled_back": False, "error": "no canary active"}
        version, _fraction, addrs = canary
        committed = self.coordinator.committed_version
        with tracing.span("router.canary", action="rollback",
                          version=version, to=committed):
            healed = [addr for addr in sorted(addrs)
                      if self.coordinator.push_version(
                          addr, committed, rollback=True)]
            # The slice dissolves either way: a replica that refused
            # the downgrade (or died) is simply not routable until the
            # prober/healer sort it out — it must not keep owning p%
            # of the key ring.
            self._canary = None
            self.state.bump("router.canary_rolled_back")
        logger.info("canary rollback of %d -> %d: healed %s", version,
                    committed, healed)
        return {"rolled_back": True, "healed": healed,
                "committed_version": committed}

    def external_rollout(self, version, freshness_seconds=None,
                         timeout=600.0):
        """In-process form of POST /fleet/rollout (the bench and an
        embedded aggregation tier call this directly)."""
        return self._command(
            "rollout", {"version": version,
                        "freshness_seconds": freshness_seconds},
            timeout)

    def start_canary(self, version, fraction, replicas=None,
                     freshness_seconds=None, timeout=600.0):
        return self._command(
            "canary_start",
            {"version": version, "fraction": fraction,
             "replicas": replicas,
             "freshness_seconds": freshness_seconds}, timeout)

    def promote_canary(self, timeout=600.0):
        return self._command("canary_promote", {}, timeout)

    def rollback_canary(self, timeout=600.0):
        return self._command("canary_rollback", {}, timeout)

    def canary_view(self):
        """(version, fraction, frozenset(addrs)) or None — ONE atomic
        read, the routing hot path's view."""
        return self._canary

    def canary_addrs(self):
        canary = self._canary
        return canary[2] if canary is not None else frozenset()

    # -- elastic membership (the autoscaler's surface) -----------------

    def add_replica(self, addr):
        """Admit a replica the autoscaler just spawned: pooled + in
        the table (unroutable until its first successful probe)."""
        self._pools.setdefault(addr,
                               _ConnPool(addr, self.request_timeout))
        self.state.add_replica(addr)

    def remove_replica(self, addr):
        """Retire a drained replica (autoscaler scale-down: no
        in-flight forwards reference it — the autoscaler waited)."""
        self.state.remove_replica(addr)
        pool = self._pools.pop(addr, None)
        if pool is not None:
            pool.clear()
        # Retire its latency histogram too: over autoscaler churn the
        # dict (and the /metrics payload) would otherwise grow one
        # full histogram block per EVER-seen replica address, exporting
        # long-dead replicas forever — the stale-series class the
        # worker-telemetry eviction already kills on the master.
        with self._replica_lat_lock:
            self._replica_lat.pop(addr, None)

    # -- routing -------------------------------------------------------

    @staticmethod
    def routing_key(path, headers, body):
        """The affinity key, if the request has one: explicit header,
        explicit JSON field, else the embedding table for lookups
        (keeps one table's hot rows in ONE replica's cache).  Predicts
        without a key are stateless — load balance them instead."""
        key = headers.get("X-Routing-Key")
        if key:
            return key
        if isinstance(body, dict):
            if body.get("routing_key"):
                return str(body["routing_key"])
            if path.endswith(":lookup") and "table" in body:
                return "table:%s" % body["table"]
        return None

    def forward(self, method, path, raw_body, key=None,
                content_type=None):
        """Forward one request; returns (status, body_bytes,
        content_type, replica_addr).  ``content_type`` is the INBOUND
        body's type, passed through to the replica verbatim — a binary
        frame body is forwarded byte-identically, never re-encoded
        (docs/serving.md "Wire protocol").  A transport-level failure
        ejects the replica and retries on a survivor exactly once.
        Replica selection (``FleetState.acquire``) counts the forward
        in-flight atomically with the pick, so concurrent keyless
        requests spread instead of herding onto one momentarily-idle
        replica.

        With a canary active, keyed requests whose key falls on the
        canary slice of the ring (``canary_slice(key) < p``) route
        ONLY among the canary replicas (pinned at the canary version);
        everything else — baseline keys and keyless traffic — routes
        only among the rest.  Cohorts are disjoint by key, so any one
        key's ``model_version`` stays monotone through start → soak →
        promote.  Per-cohort request/error/latency series feed
        /metrics (the promote-or-rollback evidence)."""
        canary = self._canary
        cohort = "baseline"
        # The baseline pin is a CALLABLE re-read on every acquire
        # attempt: a request straddling a fleet version flip must pick
        # up the new committed version on its next try, not spin out
        # its grace against a version no replica serves anymore.  The
        # canary pin stays fixed — that pool is defined by its version.
        version_pin = self.committed_view
        members, exclude_members = None, ()
        if canary is not None:
            version, fraction, addrs = canary
            if key is not None and canary_slice(key) < fraction:
                cohort = "canary"
                version_pin = lambda: version  # noqa: E731
                members = addrs
            else:
                exclude_members = addrs
        start = time.monotonic()
        status, body, resp_type, addr = self._forward_pool(
            method, path, raw_body, key, version_pin,
            members=members, exclude_members=exclude_members,
            content_type=content_type)
        if cohort == "canary" and addr is None:
            # The whole canary pool died mid-canary: fall back to
            # baseline (the key regresses to the committed version —
            # availability beats the canary experiment) and say so.
            # The request is then BASELINE evidence: counting it under
            # the canary cohort would let a dead canary pool promote
            # on requests the canary version never served.
            self.state.bump("router.canary_fallback")
            cohort = "baseline"
            version_pin = self.committed_view
            status, body, resp_type, addr = self._forward_pool(
                method, path, raw_body, key, self.committed_view,
                exclude_members=addrs, content_type=content_type)
        elapsed = time.monotonic() - start
        self._note_cohort(
            cohort, keyed=key is not None,
            latency_ms=1e3 * elapsed,
            error=status >= 500,
            version=version_pin())
        self._cohort_lat[cohort].observe(elapsed)
        if addr is not None:
            with self._replica_lat_lock:
                h = self._replica_lat.get(addr)
                if h is None:
                    h = self._replica_lat[addr] = Histogram()
            h.observe(elapsed)
        return status, body, resp_type, addr

    def _note_cohort(self, cohort, keyed, latency_ms, error, version):
        with self._cohort_lock:
            c = self._cohorts[cohort]
            c["requests"] += 1
            if keyed:
                c["keyed_requests"] += 1
            if error:
                c["errors"] += 1
            c["latency_ms_sum"] += latency_ms
            if version:
                c["model_version"] = int(version)

    def cohort_stats(self):
        with self._cohort_lock:
            out = {name: dict(c)
                   for name, c in self._cohorts.items()}
        for name, h in self._cohort_lat.items():
            snap = h.snapshot()
            if snap["count"]:
                out[name]["latency_hist"] = snap
        return out

    def _forward_pool(self, method, path, raw_body, key, version_pin,
                      members=None, exclude_members=(),
                      content_type=None):
        """``version_pin`` is a CALLABLE evaluated per attempt (see
        forward(): the baseline pin must track a mid-request fleet
        flip)."""
        attempts = 0
        exclude = []
        empty_deadline = None
        while True:
            pinned = version_pin()
            addr = self.state.acquire(pinned, key=key,
                                      exclude=exclude,
                                      members=members,
                                      exclude_members=exclude_members)
            if addr is None:
                # An empty routable set is usually a BLIP — a probe
                # timed out under load and ejected the only replica,
                # or every replica is mid-flip — so ride it briefly
                # (the next successful probe readmits within the
                # probe interval) instead of bouncing the client.
                now = time.monotonic()
                if empty_deadline is None:
                    empty_deadline = now + self.no_replica_grace
                    self.state.bump("router.no_replica_waits")
                if now < empty_deadline:
                    time.sleep(0.02)
                    continue
                self.state.bump("router.no_replica")
                return 503, json.dumps(
                    {"error": "no routable replica (healthy%s)"
                              % ("" if pinned is None else
                                 " and at version %d" % pinned)}
                ).encode(), "application/json", None
            try:
                result = self._forward_to(addr, method, path,
                                          raw_body, content_type)
                if (result[0] == 503 and attempts == 0
                        and b'"draining"' in result[1]):
                    # The replica refused ADMISSION (SIGTERM drain) —
                    # nothing executed, so failing over is replay-safe,
                    # unlike other 5xx.  Mark it draining now instead
                    # of waiting out a probe interval: a scale-down
                    # drops zero requests.
                    self.state.note_draining(addr)
                    self.state.bump("router.drain_refusal_retried")
                    attempts += 1
                    exclude.append(addr)
                    continue
                return result
            except _FORWARD_ERRORS as e:
                self.state.note_forward_failure(addr, time.monotonic())
                pool = self._pools.get(addr)
                if pool is not None:
                    pool.clear()
                attempts += 1
                exclude.append(addr)
                if attempts > 1:
                    self.state.bump("router.forward_failed")
                    return 502, json.dumps(
                        {"error": "replicas %s failed: %s"
                                  % (exclude, e)}
                    ).encode(), "application/json", None
                self.state.bump("router.retried_requests")
                logger.warning("forward to %s failed (%s); retrying "
                               "once on a survivor", addr, e)
            finally:
                self.state.forward_finished(addr)

    def _forward_to(self, addr, method, path, raw_body,
                    content_type=None):
        pool = self._pools.get(addr)
        if pool is None:
            # Raced a scale-down removal between acquire and here: a
            # transient pool still forwards this one request cleanly.
            pool = _ConnPool(addr, self.request_timeout, max_idle=0)
        conn = pool.acquire()
        reusable = False
        try:
            headers = {}
            if raw_body is not None:
                # The INBOUND content type rides through: a binary
                # frame stays a binary frame at the replica (no
                # re-labeling, no re-encoding).
                headers["Content-Type"] = (content_type
                                           or "application/json")
            conn.request(method, path, body=raw_body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            content_type = resp.getheader("Content-Type",
                                          "application/json")
            reusable = (resp.getheader("Connection", "")
                        .lower() != "close")
            self.state.bump("router.forwarded")
            return resp.status, payload, content_type, addr
        finally:
            pool.release(conn, reusable)

    # -- observability -------------------------------------------------

    def latency_hists(self):
        """{replica addr: latency histogram snapshot} for replicas
        that have taken traffic."""
        with self._replica_lat_lock:
            hists = dict(self._replica_lat)
        return {addr: h.snapshot() for addr, h in hists.items()}

    def fleet_status(self):
        replicas, counters = self.state.snapshot()
        canary = self._canary
        status_slo = slo_mod.slo_section()
        return {
            "committed_version": self.coordinator.committed_version,
            "coordinating": self.coordinating,
            "auto_rollout": self.auto_rollout,
            "replicas": replicas,
            "counters": counters,
            "gate_open": self.gate.is_open,
            "canary": {
                "active": canary is not None,
                "version": canary[0] if canary else None,
                "fraction": canary[1] if canary else None,
                "replicas": sorted(canary[2]) if canary else [],
                "cohorts": self.cohort_stats(),
            },
            "latency_hists": self.latency_hists(),
            "aggregation": self._agg,
            **({"slo": status_slo} if status_slo is not None else {}),
        }


def build_router_server(router, port=0, host="127.0.0.1",
                        gate_timeout=10.0):
    """HTTP front end over a :class:`Router`.  POSTs under /v1/ (and
    /fleet-prefixed GETs the router answers itself) — everything else
    under /v1/ forwards too, so TF-Serving metadata GETs keep working
    through the fleet."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive toward clients,
        # same discipline (and Content-Length guarantee) as the model
        # server's handler — including the anti-Nagle response-path
        # settings (see serving/server.py: a header+body write pair
        # on a keep-alive socket costs a 40 ms delayed-ACK stall).
        disable_nagle_algorithm = True
        wbufsize = -1

        def log_message(self, fmt, *args):
            logger.debug("router: " + fmt, *args)

        def _reply_raw(self, code, body, content_type):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, payload):
            self._reply_raw(code, json.dumps(payload).encode(),
                            "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply_json(200, {"status": "ok"})
            if self.path in ("/statz", "/fleet/status"):
                return self._reply_json(200, router.fleet_status())
            if self.path == "/metrics":
                return self._reply_raw(
                    200,
                    fleet_to_prometheus(router.fleet_status()).encode(),
                    "text/plain; version=0.0.4")
            if tracing.is_tracez_path(self.path):
                # Router flight recorder: barrier spans, ejections,
                # failovers — same query API as every other tier.
                return self._reply_raw(
                    200, tracing.tracez_body(self.path).encode(),
                    "application/json")
            if slo_mod.is_alertz_path(self.path):
                # SLO watchdog surface (utils/slo.py) — same API as
                # every other tier's /alertz.
                return self._reply_raw(
                    200, slo_mod.alertz_body().encode(),
                    "application/json")
            if self.path.startswith("/v1/"):
                status, body, content_type, _ = router.forward(
                    "GET", self.path, None)
                return self._reply_raw(status, body, content_type)
            self._reply_json(404, {"error": "unknown path %r"
                                            % self.path})

        def do_POST(self):
            if self.headers.get("Transfer-Encoding") or (
                    "Content-Length" not in self.headers):
                self.close_connection = True
                return self._reply_json(
                    411, {"error": "Content-Length required"})
            length = int(self.headers.get("Content-Length", 0))
            if self.path.startswith("/fleet/"):
                # Fleet-control plane (the aggregation tier's surface):
                # executes on the rollout thread, bypasses the
                # admission gate — a rollout command must be able to
                # land WHILE the gate is closed for its own barrier.
                raw = self.rfile.read(length)
                try:
                    payload = json.loads(raw or b"{}")
                    return self._fleet_control(payload)
                except (KeyError, TypeError, ValueError) as e:
                    return self._reply_json(
                        400, {"error": "bad fleet command: %s" % e})
            if not self.path.startswith("/v1/"):
                self.rfile.read(length)  # keep the connection framed
                return self._reply_json(
                    404, {"error": "unknown path %r" % self.path})
            content_type = self.headers.get("Content-Type",
                                            "application/json")
            got = self._routed_body(length, content_type)
            if got is None:
                return  # malformed frame; already replied 400
            key, raw = got
            # The version-flip barrier: requests admitted here are
            # drained before a fleet commit flips routing.
            if not router.gate.enter(timeout=gate_timeout):
                return self._reply_json(
                    503, {"error": "fleet version flip in progress"})
            try:
                status, payload, resp_type, _ = router.forward(
                    "POST", self.path, raw, key=key,
                    content_type=content_type)
                self._reply_raw(status, payload, resp_type)
            finally:
                router.gate.exit_()

        def _routed_body(self, length, content_type):
            """(routing key, raw body) with the MINIMAL body
            inspection the placement decision needs:

             - an ``X-Routing-Key`` header costs ZERO body
               inspection — the body is read once and forwarded;
             - a binary frame costs exactly the preamble + header
               read (``tensor_codec.read_frame_header``): the key is
               in the frame header, the payload is read straight
               through afterwards and spliced back verbatim — the
               router never decodes, re-parses, or re-encodes a
               tensor payload;
             - only the JSON compatibility fallback still parses the
               whole body (the ``routing_key`` field can be anywhere
               in it).

            Returns None after replying when a frame is malformed."""
            explicit = self.headers.get("X-Routing-Key")
            if explicit:
                return explicit, self.rfile.read(length)
            if tensor_codec.is_frame_content_type(content_type):
                if length < tensor_codec.FRAME_PREAMBLE_SIZE:
                    self.rfile.read(length)
                    self._reply_json(
                        400, {"error": "bad frame: body shorter than "
                                       "the preamble"})
                    return None
                try:
                    header, prefix, _payload_len = \
                        tensor_codec.read_frame_header(
                            self.rfile, limit=length)
                except tensor_codec.FrameError as e:
                    # The consumed byte count is ambiguous mid-error:
                    # close instead of guessing at re-framing the
                    # keep-alive stream.
                    self.close_connection = True
                    self._reply_json(400,
                                     {"error": "bad frame: %s" % e})
                    return None
                rest = self.rfile.read(length - len(prefix))
                key = header.get("routing_key")
                if not key and self.path.endswith(":lookup"):
                    # The SAME table-affinity key the JSON path
                    # derives ("table:<name>"), so one table's hot
                    # rows stay in ONE replica's embedding cache
                    # regardless of the request's content type.
                    meta = header.get("meta")
                    table = (meta.get("table")
                             if isinstance(meta, dict) else None)
                    if table:
                        key = "table:%s" % table
                return key, prefix + rest
            raw = self.rfile.read(length)
            body = None
            if raw:
                try:
                    body = json.loads(raw)
                except ValueError:
                    body = None  # replica will 400 it; no key
            return Router.routing_key(self.path, self.headers,
                                      body), raw

        def _fleet_control(self, payload):
            if self.path == "/fleet/rollout":
                return self._reply_json(
                    200, router.external_rollout(
                        payload["version"],
                        payload.get("freshness_seconds")))
            if self.path == "/fleet/canary":
                return self._reply_json(
                    200, router.start_canary(
                        payload["version"],
                        payload.get("fraction", 0.1),
                        replicas=payload.get("replicas"),
                        freshness_seconds=payload.get(
                            "freshness_seconds")))
            if self.path == "/fleet/canary/promote":
                return self._reply_json(200, router.promote_canary())
            if self.path == "/fleet/canary/rollback":
                return self._reply_json(200, router.rollback_canary())
            return self._reply_json(
                404, {"error": "unknown path %r" % self.path})

    server = ThreadingHTTPServer((host, port), Handler)
    server.router = router
    return server


def main(argv=None):
    args = build_router_parser().parse_args(argv)
    tracing.configure_identity("router", rank=args.port)
    tracing.arm_crash_dump()
    replicas = [a.strip() for a in args.replicas.split(",")
                if a.strip()]
    if not replicas:
        raise SystemExit("--replicas must name at least one "
                         "host:port")
    router = Router(
        replicas, export_dir=args.export_dir,
        probe_interval=args.probe_interval,
        probe_timeout=args.probe_timeout,
        request_timeout=args.request_timeout,
        barrier_timeout=args.barrier_timeout,
        poll_interval=args.poll_interval,
        auto_rollout=args.auto_rollout,
    )
    autoscaler = spawner = None
    if args.autoscale:
        if not args.export_dir:
            raise SystemExit("--autoscale needs --export_dir (spawned "
                             "replicas must load from somewhere)")
        from elasticdl_tpu_torch.serving.fleet import (
            FleetAutoscaler,
            ProcessReplicaSpawner,
        )

        spawner = ProcessReplicaSpawner(args.export_dir)
        autoscaler = FleetAutoscaler(
            router, spawner,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            scale_up_queue_ms=args.scale_up_queue_ms,
            scale_down_queue_ms=args.scale_down_queue_ms,
            breach_secs=args.breach_secs,
            idle_secs=args.idle_secs,
            cooldown_secs=args.autoscale_cooldown_secs,
        )
    # SLO rules from the environment (ELASTICDL_SLO_SPEC): cohort
    # latency distributions are the natural sources here, e.g.
    # "p99(cohort_latency) < 0.25" over the baseline cohort.
    wd = slo_mod.default_watchdog()
    wd.add_source(
        "cohort_latency",
        lambda: router._cohort_lat["baseline"].snapshot())
    wd.arm_from_env()
    server = build_router_server(router, port=args.port,
                                 host=args.host)
    router.start()
    if autoscaler is not None:
        autoscaler.start()
    logger.info(
        "fleet router on %s:%d over %d replica(s) %s (rollout "
        "coordination: %s; autoscale: %s)", args.host,
        server.server_address[1], len(replicas), replicas,
        ("on, scanning %s%s" % (args.export_dir,
                                "" if args.auto_rollout
                                else " (external rollouts only)"))
        if args.export_dir else "off",
        "%d..%d replicas" % (args.min_replicas, args.max_replicas)
        if autoscaler is not None else "off")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if autoscaler is not None:
            autoscaler.stop()
        router.stop()
        if spawner is not None:
            spawner.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
