"""Fleet control plane for the serving tier.

Two cooperating pieces, both owned by the router process
(serving/router.py):

 - :class:`FleetState` + :class:`HealthProber` — the replica table.
   One prober thread polls each replica's existing ``/statz``
   (docs/serving.md): a reply feeds the load signal (batch occupancy,
   queue wait) and the replica's serving version; a miss EJECTS the
   replica from routing.  Ejected replicas are ridden back in with
   JITTERED exponential-backoff probes (the shared
   ``utils/retry.RetryPolicy`` backoff math — deterministic per
   process, so drills replay), exactly the outage-riding idiom the
   worker's PS client uses for shard relaunches.

 - :class:`FleetCoordinator` — fleet-wide hot-swap with no
   mixed-version window.  The "all-N-ready then publish" idiom of the
   PS tier's coordinated checkpoints (utils/checkpoint.py: a version
   COMMITS only once every shard's file exists): a new complete export
   version is first PRE-WARMED on every healthy replica
   (``/fleet/prepare`` — the PR-3 background warm path, so no request
   ever pays a cold XLA compile), the coordinator polls
   ``/fleet/state`` until all of them report the version ready, and
   only then runs the barrier: close the router's admission gate,
   drain in-flight forwards, ``/fleet/commit`` everywhere, flip the
   committed version, reopen.  Stale-version requests therefore DRAIN
   before the flip — a client can never observe version V+1 and then
   V again, for any key.

   A replica that restarts mid-rollout rejoins at whatever version its
   local disk gave it; the coordinator HEALS it to the fleet's
   committed version (prepare + commit, no gate needed — it is not
   routable until it matches) before routing touches it.  The
   committed version is therefore seeded from the coordinator, never
   from a rejoining replica's own disk scan, and a replica-side check
   (``ModelEndpoint.commit_version`` refuses regressions) backs the
   invariant even against a confused coordinator.
"""

import hashlib
import http.client
import json
import threading
import time

from elasticdl_tpu_torch.serving.loader import list_versions
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.retry import serving_probe_policy

logger = get_logger(__name__)


def rendezvous_rank(key, addrs):
    """Replicas ordered by highest-random-weight score for ``key``.

    Each (key, replica) pair hashes independently, so removing a
    replica only re-homes ITS keys (to their second choice) and adding
    one steals ~1/N of each survivor's keyspace — no ring state to
    persist or rebalance, which is why rendezvous beats a ring here
    (the fleet is small and membership churns with every eject)."""
    def score(addr):
        return hashlib.blake2b(
            ("%s|%s" % (key, addr)).encode(), digest_size=8,
        ).digest()
    return sorted(addrs, key=score, reverse=True)


def pick_replica(key, addrs):
    return rendezvous_rank(key, addrs)[0] if addrs else None


def canary_slice(key):
    """Deterministic position of ``key`` on the unit interval — the
    canary keyspace slice (docs/serving.md "The online loop"): keys
    with ``canary_slice(key) < p`` form the p% canary cohort.  Hashed
    INDEPENDENTLY of the rendezvous placement hash (different salt),
    so the canary cohort is an unbiased cut across every replica's
    keyspace, not one replica's keys."""
    digest = hashlib.blake2b(("canary|%s" % key).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


def http_get_json(addr, path, timeout):
    """One GET against a replica; fresh connection (control plane —
    low rate, and a dead replica must not poison a pooled socket)."""
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host or addr, int(port),
                                      timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise OSError("GET %s on %s -> %d" % (path, addr,
                                                  resp.status))
        return json.loads(payload)
    finally:
        conn.close()


def http_post_json(addr, path, payload, timeout):
    host, _, port = addr.rpartition(":")
    conn = http.client.HTTPConnection(host or addr, int(port),
                                      timeout=timeout)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise OSError("POST %s on %s -> %d" % (path, addr,
                                                   resp.status))
        return json.loads(raw)
    finally:
        conn.close()


class _Replica:
    """One replica's row in the table.  Plain data: every access goes
    through FleetState under its lock."""

    __slots__ = (
        "addr", "healthy", "draining", "serving_version",
        "occupancy", "queue_wait_ms", "inflight", "failures",
        "next_probe_at", "ever_probed",
        "qw_count", "qw_sum_s", "queue_wait_recent_ms",
        "queue_wait_diff_ms",
    )

    def __init__(self, addr):
        self.addr = addr
        self.healthy = False      # never routed before the first probe
        self.draining = False
        self.serving_version = 0
        self.occupancy = None
        self.queue_wait_ms = None
        self.inflight = 0         # router-side live forwards
        self.failures = 0         # consecutive probe/forward failures
        self.next_probe_at = 0.0  # due immediately
        self.ever_probed = False
        # Windowed queue-wait (the autoscaler's load signal).  The
        # replica now reports its OWN windowed value on /statz
        # (``queue_wait_recent_ms``, straight from its histogram);
        # probe differencing of the cumulative (count, sum) remains as
        # a CROSS-CHECK (``queue_wait_diff_ms``) and as the fallback
        # toward replicas predating the field.
        self.qw_count = 0
        self.qw_sum_s = 0.0
        self.queue_wait_recent_ms = None
        self.queue_wait_diff_ms = None


def _statz_view(statz):
    """(serving_version, occupancy, queue_wait_ms, recent_ms,
    draining) out of a replica's /statz payload.  Multi-model replicas
    report the MINIMUM serving version — the fleet barrier must hold
    for every model the replica hosts.  ``recent_ms`` is the replica's
    OWN windowed queue wait (histogram-backed, serving/server.py
    stats()); None from replicas predating the field."""
    models = statz.get("models", {})
    version = min(
        (int(stats.get("version", 0) or 0)
         for stats in models.values()),
        default=0,
    )
    occupancy = None
    queue_wait_ms = None
    recent_ms = None
    for stats in models.values():
        if stats.get("mean_batch_occupancy") is not None:
            occupancy = stats["mean_batch_occupancy"]
        wait = stats.get("timing", {}).get("batcher.queue_wait")
        if wait and wait.get("count"):
            queue_wait_ms = 1e3 * wait["mean_s"]
        if stats.get("queue_wait_recent_ms") is not None:
            recent_ms = (max(recent_ms, stats["queue_wait_recent_ms"])
                         if recent_ms is not None
                         else stats["queue_wait_recent_ms"])
    return version, occupancy, queue_wait_ms, recent_ms, bool(
        statz.get("draining"))


def _statz_queue_totals(statz):
    """Cumulative (observation count, sum of seconds) of queue wait
    across a replica's models — the raw series the autoscaler's
    probe-interval differencing runs on."""
    count, total = 0, 0.0
    for stats in statz.get("models", {}).values():
        wait = stats.get("timing", {}).get("batcher.queue_wait")
        if wait and wait.get("count"):
            count += int(wait["count"])
            total += float(wait["count"]) * float(wait["mean_s"])
    return count, total


class FleetState:
    """Concurrent replica table: probe results in, routing/load
    decisions out.  All mutation under one lock; nothing blocking ever
    runs under it (probes and forwards happen in the callers)."""

    def __init__(self, addrs, probe_interval=0.5, backoff=None):
        self.probe_interval = float(probe_interval)
        self._backoff = backoff or serving_probe_policy()
        self._lock = threading.Lock()
        self._replicas = {addr: _Replica(addr) for addr in addrs}
        self._counters = {}
        self._rr = 0  # least-loaded tie rotation

    # -- counters ------------------------------------------------------

    def bump(self, name, n=1):
        """Router observability counters (forwards, retries, ejects) —
        bumped from many request threads, so guarded here rather than
        relying on Timing's single-writer convention."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    # -- probe bookkeeping ---------------------------------------------

    def due_probes(self, now):
        with self._lock:
            return [r.addr for r in self._replicas.values()
                    if r.next_probe_at <= now]

    def note_probe_ok(self, addr, statz, now):
        (version, occupancy, queue_wait_ms, recent_ms,
         draining) = _statz_view(statz)
        qw_count, qw_sum_s = _statz_queue_totals(statz)
        with self._lock:
            r = self._replicas.get(addr)
            if r is None:
                return  # removed (autoscaler shrink) mid-probe
            came_back = not r.healthy and r.ever_probed
            r.healthy = True
            r.ever_probed = True
            r.draining = draining
            r.serving_version = version
            r.occupancy = occupancy
            r.queue_wait_ms = queue_wait_ms
            if qw_count > r.qw_count:
                r.queue_wait_diff_ms = (
                    1e3 * (qw_sum_s - r.qw_sum_s)
                    / (qw_count - r.qw_count))
            elif qw_count < r.qw_count:
                # Replica restarted on the same port: counters reset.
                r.queue_wait_diff_ms = None
            else:
                # No traffic this interval — an idle replica has zero
                # recent queue wait by definition.
                r.queue_wait_diff_ms = 0.0
            r.qw_count, r.qw_sum_s = qw_count, qw_sum_s
            # The EFFECTIVE recent-load signal (autoscaler input):
            # the replica's own histogram-windowed report when
            # present, probe differencing as the fallback — and the
            # differenced value stays visible as a cross-check.
            r.queue_wait_recent_ms = (
                recent_ms if recent_ms is not None
                else r.queue_wait_diff_ms)
            r.failures = 0
            r.next_probe_at = now + self.probe_interval
        if came_back:
            logger.info("replica %s back in service (version %d%s)",
                        addr, version,
                        ", draining" if draining else "")

    def note_probe_failure(self, addr, now):
        with self._lock:
            r = self._replicas.get(addr)
            if r is None:
                return
            was_healthy = r.healthy
            r.healthy = False
            r.ever_probed = True
            r.failures += 1
            # Jittered exponential backoff toward a dead replica: probe
            # attempt N waits the policy's delay for attempt N-1 (capped
            # at its max), so a flapping replica is not hammered and a
            # relaunch on the same port is still caught within seconds.
            r.next_probe_at = now + self._backoff.delay_secs(
                min(r.failures - 1, 8))
        if was_healthy:
            logger.warning("replica %s ejected (probe failure #%d)",
                           addr, self._failures(addr))

    def _failures(self, addr):
        with self._lock:
            r = self._replicas.get(addr)
            return r.failures if r is not None else 0

    # -- elastic membership (the autoscaler's surface) -----------------

    def add_replica(self, addr):
        """Admit a new replica to the table (unprobed — it takes no
        traffic until its first successful /statz probe)."""
        with self._lock:
            if addr not in self._replicas:
                self._replicas[addr] = _Replica(addr)

    def remove_replica(self, addr):
        """Drop a replica from the table (scale-down AFTER its drain:
        the caller guarantees no in-flight forwards reference it)."""
        with self._lock:
            self._replicas.pop(addr, None)

    def replica_row(self, addr):
        """One replica's snapshot row, or None."""
        snapshot, _ = self.snapshot()
        return snapshot.get(addr)

    def note_committed(self, addr, version):
        """A commit POST just succeeded on ``addr``: reflect its new
        serving version NOW instead of waiting out a probe interval —
        otherwise the instant after a fleet flip no replica would match
        the new committed version and routing would blip empty."""
        with self._lock:
            r = self._replicas.get(addr)
            if r is not None:
                r.serving_version = max(r.serving_version,
                                        int(version))

    def note_version(self, addr, version):
        """SET a replica's serving version — the canary ROLLBACK path,
        where the version deliberately moves backwards
        (``note_committed``'s max() would mask the regression and keep
        routing the replica at the rolled-back version)."""
        with self._lock:
            r = self._replicas.get(addr)
            if r is not None:
                r.serving_version = int(version)

    def note_draining(self, addr):
        """A forward was refused with the replica's draining marker:
        take it out of routing NOW instead of waiting out the probe
        interval (the refusal IS a probe: the replica answered, and
        said it admits nothing)."""
        with self._lock:
            r = self._replicas.get(addr)
            if r is not None:
                r.draining = True

    def note_forward_failure(self, addr, now):
        """A live forward hit a dead socket: eject NOW (don't wait for
        the prober) and schedule an immediate re-probe."""
        with self._lock:
            r = self._replicas.get(addr)
            if r is None:
                return
            was_healthy = r.healthy
            r.healthy = False
            r.failures += 1
            r.next_probe_at = now
        if was_healthy:
            logger.warning("replica %s ejected (forward failed)", addr)

    # -- router-side load accounting -----------------------------------

    def forward_finished(self, addr):
        with self._lock:
            r = self._replicas.get(addr)
            if r is not None:
                r.inflight -= 1

    # -- routing views -------------------------------------------------

    def _routable_locked(self, committed_version):
        return [
            r.addr for r in self._replicas.values()
            if r.healthy and not r.draining and (
                committed_version is None
                or r.serving_version == committed_version)
        ]

    def routable(self, committed_version=None):
        """Addresses traffic may go to: healthy, not draining, and —
        when the fleet has a committed version — serving exactly it
        (a healed-but-lagging or racing-ahead replica is NOT routable,
        which is what makes the version flip atomic per key)."""
        with self._lock:
            return self._routable_locked(committed_version)

    def acquire(self, committed_version, key=None, exclude=(),
                members=None, exclude_members=()):
        """Pick a replica AND count the forward in-flight, atomically
        (caller pairs with :meth:`forward_finished`).  Keyed requests
        go by rendezvous hash; keyless take the least-loaded replica —
        live in-flight first (exact and instant), then the probed
        queue-wait/occupancy — with TIES rotated, not address-ordered.
        The pick and the increment share one lock region: two
        concurrent keyless requests can no longer both observe
        inflight==0 on the same replica and herd onto it.

        ``members`` / ``exclude_members`` restrict the candidate pool
        — the router's canary cohorts: canary-slice keys pick ONLY
        among the canary replicas (pinned at the canary version),
        baseline traffic only among the rest."""
        with self._lock:
            candidates = [a for a in
                          self._routable_locked(committed_version)
                          if a not in exclude
                          and a not in exclude_members
                          and (members is None or a in members)]
            if not candidates:
                return None
            if key is not None:
                addr = pick_replica(key, candidates)
            else:
                def load(a):
                    r = self._replicas[a]
                    return (r.inflight, r.queue_wait_ms or 0.0,
                            r.occupancy or 0.0)
                best = min(load(a) for a in candidates)
                tied = [a for a in candidates if load(a) == best]
                self._rr += 1
                addr = tied[self._rr % len(tied)]
            self._replicas[addr].inflight += 1
            return addr

    def barrier_set(self):
        """Replicas the rollout barrier must wait for: healthy and not
        draining (a replica that dies mid-prepare drops out of the
        wait on its next missed probe)."""
        with self._lock:
            return [r.addr for r in self._replicas.values()
                    if r.healthy and not r.draining]

    def serving_versions(self):
        with self._lock:
            return {r.addr: r.serving_version
                    for r in self._replicas.values() if r.healthy}

    def snapshot(self):
        with self._lock:
            counters = dict(self._counters)
            return {
                r.addr: {
                    "healthy": r.healthy,
                    "draining": r.draining,
                    "serving_version": r.serving_version,
                    "occupancy": r.occupancy,
                    "queue_wait_ms": r.queue_wait_ms,
                    "queue_wait_recent_ms": r.queue_wait_recent_ms,
                    "queue_wait_diff_ms": r.queue_wait_diff_ms,
                    "inflight": r.inflight,
                    "failures": r.failures,
                }
                for r in self._replicas.values()
            }, counters


class HealthProber:
    """One daemon thread polling each replica's /statz on its own
    schedule (healthy: every ``probe_interval``; ejected: the jittered
    backoff FleetState keeps per replica)."""

    def __init__(self, state, probe_timeout=2.0):
        self.state = state
        self.probe_timeout = probe_timeout
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-prober")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def probe_once(self, now=None):
        """One pass over every due replica (exposed for tests and for
        the coordinator's pre-rollout refresh)."""
        now = time.monotonic() if now is None else now
        for addr in self.state.due_probes(now):
            try:
                statz = http_get_json(addr, "/statz",
                                      self.probe_timeout)
            except Exception:  # noqa: BLE001 — dead/hung/mid-restart
                # replica: any failure mode means "not routable"
                self.state.note_probe_failure(addr, time.monotonic())
            else:
                self.state.note_probe_ok(addr, statz,
                                         time.monotonic())

    def _run(self):
        quantum = min(0.05, self.state.probe_interval / 4 or 0.05)
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(quantum)


class FleetCoordinator:
    """Version-barrier hot-swap over a FleetState (module docstring has
    the protocol).  Driven by the router's rollout thread calling
    :meth:`tick`; everything here runs OUTSIDE the routing hot path —
    the only touch point is the admission gate around the commit."""

    def __init__(self, state, export_dir, gate=None,
                 http_timeout=5.0, barrier_timeout=120.0,
                 ready_poll_secs=0.1):
        self.state = state
        self.export_dir = export_dir
        self.gate = gate
        self.http_timeout = http_timeout
        self.barrier_timeout = barrier_timeout
        self.ready_poll_secs = ready_poll_secs
        # Single-writer (the rollout thread) once ticking starts;
        # published for readers via the GIL-atomic attribute read —
        # the router reads it per request, flipped only inside the
        # closed-gate barrier.
        self.committed_version = 0
        self._seeded = False

    @property
    def seeded(self):
        return self._seeded

    # -- seeding -------------------------------------------------------

    def seed_committed(self):
        """First tick: adopt the fleet's actual state as the committed
        version — the version MOST healthy replicas serve, ties broken
        HIGH.  The old rule (plain max) assumed versions only move via
        fleet commits; canary slicing broke that: a MINORITY of canary
        replicas runs AHEAD of the committed version, and a router
        restarting mid-canary (its in-memory canary state lost) must
        not adopt — and then heal the whole fleet up to — an unvetted
        version a soak may have been about to roll back.  With the
        modal seed the orphaned canary minority is merely unroutable
        until the next rollout re-collects it.  Ties keep the MAX: a
        1-vs-1 split is also exactly the lagging-rejoiner shape (one
        replica healing up to what the fleet agreed on), and healing
        the rejoiner up is the PR-9 guarantee; the residual edge — a
        canary slicing HALF a 2-replica fleet plus a router restart
        mid-soak — trades against it.  An empty/unprobed fleet falls
        back to the newest complete export on disk."""
        versions = self.state.serving_versions()
        if versions:
            counts = {}
            for version in versions.values():
                counts[version] = counts.get(version, 0) + 1
            self.committed_version = max(
                version for version, n in counts.items()
                if n == max(counts.values()))
            self._seeded = True
            logger.info("fleet committed version seeded from replicas: "
                        "%d", self.committed_version)
            return True
        if self.export_dir:
            try:
                complete = list_versions(self.export_dir)
            except OSError:
                complete = []
            if complete:
                self.committed_version = complete[-1]
                self._seeded = True
                logger.info("fleet committed version seeded from "
                            "export dir: %d", self.committed_version)
                return True
        return False

    # -- rollout -------------------------------------------------------

    def target_version(self):
        """Newest complete export version beyond the committed one, or
        None."""
        if not self.export_dir:
            return None
        versions = list_versions(self.export_dir)
        if versions and versions[-1] > self.committed_version:
            return versions[-1]
        return None

    def tick(self, scan=True):
        """One coordination pass: seed if needed, heal lagging
        rejoiners, and — when ``scan`` — roll out a new complete
        export version.  The router passes ``scan=False`` in
        aggregator-driven mode (``--auto_rollout false``) and while a
        canary is active: seeding and healing must keep running, but
        only ONE authority may mint rollouts at a time."""
        if not self._seeded and not self.seed_committed():
            return
        self.heal_lagging()
        if not scan:
            return
        target = self.target_version()
        if target is not None:
            self.rollout(target)

    def heal_lagging(self):
        """Bring a healthy replica serving an OLD version (a rejoiner
        that restarted mid-rollout and booted off its local disk) up to
        the fleet's committed version: prepare, then commit once ready.
        No gate needed — a lagging replica is not routable until its
        serving version matches, so its flip cannot mix versions."""
        committed = self.committed_version
        for addr, version in sorted(
                self.state.serving_versions().items()):
            if version >= committed:
                continue
            try:
                http_post_json(addr, "/fleet/prepare",
                               {"version": committed},
                               self.http_timeout)
                if self._replica_ready(addr, committed):
                    result = http_post_json(
                        addr, "/fleet/commit", {"version": committed},
                        self.http_timeout)
                    if self._commit_ok(result):
                        self.state.note_committed(addr, committed)
                        self.state.bump("router.healed_replicas")
                    logger.info("healed replica %s to committed "
                                "version %d: %s", addr, committed,
                                result)
            except Exception as e:  # noqa: BLE001 — a replica that
                # dies mid-heal is just ejected again by the prober
                logger.warning("healing %s to version %d failed: %s",
                               addr, committed, e)

    @staticmethod
    def _commit_ok(result):
        """A replica's /fleet/commit reply: every hosted model must
        have taken the version."""
        return bool(result) and all(
            model.get("committed") for model in result.values())

    def _replica_ready(self, addr, version, rollback=False):
        """True once the replica reports ``version`` warm (prepared) or
        already serving.  For a ROLLBACK push only exact-serving
        counts — "serving something newer" is precisely the state the
        rollback exists to undo."""
        state = http_get_json(addr, "/fleet/state", self.http_timeout)
        for model_state in state.get("models", {}).values():
            serving = model_state.get("serving", 0)
            ready = (model_state.get("prepared") == version
                     or (serving == version if rollback
                         else serving >= version))
            if not ready:
                return False
        return bool(state.get("models"))

    def push_version(self, addr, version, rollback=False,
                     timeout=None):
        """Drive ONE replica to ``version``: prepare, wait warm,
        commit.  The per-replica half of the barrier protocol, reused
        by canary slicing (push the canary replicas ahead) and canary
        rollback (push them back down, ``rollback=True`` — the
        replica's regression refusal is explicitly waived for this
        operator action and nothing else).  No admission gate: a
        replica serving a version outside the routed set is not
        routable for that cohort, so its flip cannot mix versions."""
        version = int(version)
        deadline = time.monotonic() + (self.barrier_timeout
                                       if timeout is None else timeout)
        payload = {"version": version}
        if rollback:
            payload["rollback"] = True
        http_post_json(addr, "/fleet/prepare", payload,
                       self.http_timeout)
        while not self._replica_ready(addr, version,
                                      rollback=rollback):
            if time.monotonic() >= deadline:
                logger.warning("push of %d to %s timed out preparing",
                               version, addr)
                return False
            time.sleep(self.ready_poll_secs)
        result = http_post_json(addr, "/fleet/commit", payload,
                                self.http_timeout)
        if not self._commit_ok(result):
            logger.warning("push of %d to %s refused: %s", version,
                           addr, result)
            return False
        if rollback:
            self.state.note_version(addr, version)
        else:
            self.state.note_committed(addr, version)
        return True

    def rollout(self, target):
        """The no-mixed-version hot-swap: pre-warm everywhere, wait for
        all-N-ready, then flip atomically behind the admission gate.
        One ``fleet.rollout`` span covers prepare-everywhere through
        the commit barrier (docs/observability.md)."""
        with tracing.span("fleet.rollout", target=target,
                          committed=self.committed_version):
            return self._rollout_traced(target)

    def _rollout_traced(self, target):
        logger.info("fleet rollout: version %d -> %d",
                    self.committed_version, target)
        deadline = time.monotonic() + self.barrier_timeout
        prepared = set()
        while True:
            barrier = self.state.barrier_set()
            if not barrier:
                logger.warning("rollout of %d abandoned: no healthy "
                               "replicas", target)
                return False
            pending = []
            for addr in barrier:
                try:
                    if addr not in prepared:
                        http_post_json(addr, "/fleet/prepare",
                                       {"version": target},
                                       self.http_timeout)
                        prepared.add(addr)
                    if not self._replica_ready(addr, target):
                        pending.append(addr)
                except Exception as e:  # noqa: BLE001 — replica died
                    # mid-prepare; the prober will eject it and the
                    # barrier set shrinks on the next pass
                    logger.warning("prepare of %d on %s failed: %s",
                                   target, addr, e)
                    pending.append(addr)
            if not pending:
                break
            if time.monotonic() >= deadline:
                logger.warning(
                    "rollout of %d abandoned: %s not ready within "
                    "%.0fs (will retry next scan)", target,
                    sorted(pending), self.barrier_timeout)
                return False
            time.sleep(self.ready_poll_secs)
        return self._commit_barrier(target)

    def _commit_barrier(self, target):
        """All replicas warm: close the admission gate, drain in-flight
        forwards, commit everywhere, flip, reopen.  The gate pause is
        milliseconds (commit publishes an already-warm model)."""
        tracing.event("fleet.barrier_close", target=target)
        if self.gate is not None:
            self.gate.close()
        try:
            if self.gate is not None and not self.gate.wait_idle(
                    self.barrier_timeout):
                logger.warning("rollout of %d: in-flight forwards did "
                               "not drain; flipping anyway after "
                               "timeout", target)
            committed_somewhere = False
            for addr in self.state.barrier_set():
                try:
                    result = http_post_json(
                        addr, "/fleet/commit", {"version": target},
                        self.http_timeout)
                    if self._commit_ok(result):
                        committed_somewhere = True
                        self.state.note_committed(addr, target)
                    logger.info("commit %d on %s: %s", target, addr,
                                result)
                except Exception as e:  # noqa: BLE001 — replica died
                    # at the worst moment: eject; it heals on rejoin
                    logger.warning("commit of %d on %s failed: %s",
                                   target, addr, e)
                    self.state.note_forward_failure(
                        addr, time.monotonic())
            if not committed_somewhere:
                logger.warning("rollout of %d aborted at commit: no "
                               "replica accepted", target)
                return False
            self.committed_version = target
            self.state.bump("router.rollouts")
        finally:
            if self.gate is not None:
                self.gate.open()
            tracing.event("fleet.barrier_open", target=target)
        logger.info("fleet committed version is now %d", target)
        return True


class ProcessReplicaSpawner:
    """Launches/retires serving-replica SUBPROCESSES for the
    autoscaler (``python -m elasticdl_tpu_torch.serving.server`` per
    replica, ``--fleet_managed`` so version changes only arrive via
    the barrier, ``--boot_version`` pinned to the fleet's committed
    version so a spawn mid-canary cannot race ahead off its disk
    scan).  Single-threaded by contract: only the autoscaler thread
    (and, after it stops, ``close``) touches this object."""

    def __init__(self, export_dir, host="127.0.0.1", extra_args=(),
                 env=None):
        self.export_dir = export_dir
        self.host = host
        self.extra_args = list(extra_args)
        self.env = env
        self._procs = {}  # addr -> Popen

    def spawn(self, boot_version=None):
        import subprocess
        import sys

        from elasticdl_tpu_torch.utils.grpc_utils import find_free_port

        port = find_free_port(self.host)
        cmd = [
            sys.executable, "-m", "elasticdl_tpu_torch.serving.server",
            "--export_dir", self.export_dir, "--host", self.host,
            "--port", str(port), "--fleet_managed", "true",
        ] + self.extra_args
        if boot_version:
            cmd += ["--boot_version", str(int(boot_version))]
        addr = "%s:%d" % (self.host, port)
        self._procs[addr] = subprocess.Popen(cmd, env=self.env)
        logger.info("spawned replica %s (boot_version=%s)", addr,
                    boot_version)
        return addr

    def drain(self, addr):
        """SIGTERM = the replica's graceful-drain path (PR 9): stop
        admitting, finish in-flight batches, exit."""
        import signal as _signal

        proc = self._procs.get(addr)
        if proc is not None and proc.poll() is None:
            proc.send_signal(_signal.SIGTERM)

    def reap(self, addr, timeout=15.0):
        proc = self._procs.pop(addr, None)
        if proc is None:
            return
        deadline = time.monotonic() + timeout
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    def poll(self, addr):
        """Exit code of a spawned replica's process, or None while it
        runs (also None for an addr this spawner does not own — the
        autoscaler must never declare an operator-provided replica
        dead from here)."""
        proc = self._procs.get(addr)
        return proc.poll() if proc is not None else None

    def addrs(self):
        return sorted(self._procs)

    def close(self):
        for addr in self.addrs():
            self.drain(addr)
        for addr in self.addrs():
            self.reap(addr)


class FleetAutoscaler:
    """Grow/shrink the serving-replica set off the router's OWN
    telemetry (docs/serving.md "The online loop").

    Signals — all already flowing through :class:`FleetState`:

     - scale UP on a sustained queue-wait breach: the probe-interval
       windowed queue wait (``queue_wait_recent_ms``, differenced from
       /statz cumulative counters) stays over ``scale_up_queue_ms``
       for ``breach_secs``.  Queue wait is the one signal that
       directly measures "requests waiting for capacity"; in-flight
       and occupancy ride along in the decision trace attrs.
     - scale DOWN on sustained idleness: recent queue wait under
       ``scale_down_queue_ms`` AND no in-flight backlog for
       ``idle_secs``.

    Actions:

     - grow: ``spawner.spawn(boot_version=committed)`` + admit to the
       router table; the new replica takes traffic once its first
       probe succeeds and its version matches the committed one (the
       coordinator heals it if the fleet moved while it booted).
     - shrink: pick the least-loaded non-canary replica and send it
       down the PR-9 SIGTERM graceful-drain path; it leaves the
       routable set via its own draining flag / failed probe, and is
       removed from the table only once the router holds no in-flight
       forward toward it — all admitted requests complete.

    One decision per ``cooldown_secs`` at most, each traced as a
    ``fleet.autoscale`` span and counted on /metrics
    (``router.scale_up`` / ``router.scale_down`` counters).
    """

    def __init__(self, router, spawner, min_replicas=1,
                 max_replicas=4, scale_up_queue_ms=25.0,
                 scale_down_queue_ms=2.0, breach_secs=3.0,
                 idle_secs=10.0, cooldown_secs=5.0, cadence_secs=0.5,
                 drain_timeout=30.0):
        self.router = router
        self.spawner = spawner
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.scale_up_queue_ms = float(scale_up_queue_ms)
        self.scale_down_queue_ms = float(scale_down_queue_ms)
        self.breach_secs = float(breach_secs)
        self.idle_secs = float(idle_secs)
        self.cooldown_secs = float(cooldown_secs)
        self.cadence_secs = float(cadence_secs)
        self.drain_timeout = float(drain_timeout)
        self._breach_since = None
        self._idle_since = None
        self._last_move_at = None
        self._draining = {}  # addr -> drain began (monotonic)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-autoscaler")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — one bad decision
                # pass must not kill the loop; next tick re-reads
                logger.warning("autoscaler tick failed: %s", e)
            self._stop.wait(self.cadence_secs)

    # -- one decision pass ---------------------------------------------

    def tick(self, now=None):
        now = time.monotonic() if now is None else now
        self._finish_drains(now)
        self._reap_crashed()
        snapshot, _ = self.router.state.snapshot()
        active = {a: r for a, r in snapshot.items()
                  if a not in self._draining}
        healthy = {a: r for a, r in active.items()
                   if r["healthy"] and not r["draining"]}
        if len(active) < self.min_replicas:
            # Below the floor (a spawned replica crashed and was
            # reaped): replace it regardless of any load signal — the
            # cooldown still paces replacements so a crash-looping
            # image cannot spawn-storm.
            if self._last_move_at is None or \
                    now - self._last_move_at >= self.cooldown_secs:
                self._grow(0.0, len(active), now, action="replace")
            return
        if not healthy:
            # Nothing to read a signal from (fleet still booting or
            # fully ejected) — growing blind would fight the prober.
            self._breach_since = self._idle_since = None
            return
        waits = [r["queue_wait_recent_ms"] for r in healthy.values()
                 if r["queue_wait_recent_ms"] is not None]
        queue_ms = max(waits) if waits else 0.0
        inflight = sum(r["inflight"] for r in healthy.values())
        if queue_ms >= self.scale_up_queue_ms:
            if self._breach_since is None:
                self._breach_since = now
            self._idle_since = None
        elif queue_ms <= self.scale_down_queue_ms and \
                inflight <= len(healthy):
            if self._idle_since is None:
                self._idle_since = now
            self._breach_since = None
        else:
            self._breach_since = self._idle_since = None
        if self._last_move_at is not None and \
                now - self._last_move_at < self.cooldown_secs:
            return
        if (self._breach_since is not None
                and now - self._breach_since >= self.breach_secs
                and len(active) < self.max_replicas):
            self._grow(queue_ms, len(active), now)
        elif (self._idle_since is not None
                and now - self._idle_since >= self.idle_secs
                and len(healthy) > self.min_replicas
                and len(active) > self.min_replicas):
            self._shrink(healthy, queue_ms, now)

    def _reap_crashed(self):
        """Retire replicas whose PROCESS exited without a drain (a
        crash): left in place they are counted toward max_replicas
        forever (blocking every future grow) and hold a dead address
        in the routing table.  Only processes this autoscaler's own
        spawner launched are judged — an operator-provided replica
        that merely stopped probing healthy is the prober's business,
        not ours."""
        poll = getattr(self.spawner, "poll", None)
        addrs_fn = getattr(self.spawner, "addrs", None)
        if poll is None or addrs_fn is None:
            return  # a test/fake spawner with no process model
        for addr in list(addrs_fn()):
            if addr in self._draining or poll(addr) is None:
                continue
            row = self.router.state.replica_row(addr)
            if row is not None and row["inflight"] > 0:
                continue  # let the in-flight failures surface first
            self.router.remove_replica(addr)
            self.spawner.reap(addr)
            self.router.state.bump("router.replica_crashed")
            tracing.event("fleet.autoscale_crash_reaped",
                          replica=addr)
            logger.warning("spawned replica %s exited unexpectedly; "
                           "reaped", addr)

    def _finish_drains(self, now):
        """Retire a draining replica once the router holds NO in-flight
        forward toward it and it stopped taking traffic (its own drain
        flag, or its death) — every admitted request completed."""
        for addr, since in list(self._draining.items()):
            row = self.router.state.replica_row(addr)
            gone = row is None or not row["healthy"] or row["draining"]
            idle = row is None or row["inflight"] <= 0
            if (gone and idle) or now - since > self.drain_timeout:
                self.router.remove_replica(addr)
                self.spawner.reap(addr)
                del self._draining[addr]
                tracing.event("fleet.autoscale_drained", replica=addr)
                logger.info("scale-down of %s complete", addr)

    def _grow(self, queue_ms, n_active, now, action="grow"):
        with tracing.span("fleet.autoscale", action=action,
                          replicas=n_active,
                          queue_wait_ms=round(queue_ms, 2)):
            boot = self.router.committed_view()
            addr = self.spawner.spawn(boot_version=boot)
            self.router.add_replica(addr)
        self.router.state.bump("router.scale_up")
        self._last_move_at = now
        self._breach_since = None
        logger.info("scale-up (%s): spawned %s (queue wait %.1fms "
                    "over %.1fms for %.1fs; %d -> %d replicas)",
                    action, addr, queue_ms, self.scale_up_queue_ms,
                    self.breach_secs, n_active, n_active + 1)

    def _shrink(self, healthy, queue_ms, now):
        protected = set(self.router.canary_addrs())
        # Only replicas THIS autoscaler's spawner launched are shrink
        # candidates: spawner.drain() is a no-op for an
        # operator-provided replica, so "draining" it would just
        # force-remove a live healthy replica at drain_timeout —
        # capacity silently lost, never re-added.
        addrs_fn = getattr(self.spawner, "addrs", None)
        owned = set(addrs_fn()) if addrs_fn is not None else None
        victims = [(r["inflight"], a) for a, r in healthy.items()
                   if a not in protected
                   and (owned is None or a in owned)]
        # The min_replicas floor is enforced by tick() on the healthy/
        # active counts; here only eligibility matters.
        if not victims:
            return
        _, addr = min(victims)
        with tracing.span("fleet.autoscale", action="shrink",
                          replica=addr, replicas=len(healthy),
                          queue_wait_ms=round(queue_ms, 2)):
            self.spawner.drain(addr)
        self._draining[addr] = now
        self.router.state.bump("router.scale_down")
        self._last_move_at = now
        self._idle_since = None
        logger.info("scale-down: draining %s (idle %.1fs; %d "
                    "replicas)", addr, self.idle_secs, len(healthy))
