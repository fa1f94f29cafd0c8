"""Multi-tenant elastic scheduler — J jobs over one worker pool.

The reference framework is elastic but single-job: one master owns one
job and the whole fleet.  This module is the cross-job tier ("Elastic
deep learning in multi-tenant GPU cluster", PAPERS.md): a
:class:`JobRegistry` admits J concurrent jobs — each with its own task
queue (TaskManager), rendezvous epoch space, journal namespace, and
per-job telemetry aggregate (its own :class:`MasterServicer`) — and a
:class:`ResizeController` policy loop grows and shrinks jobs over the
shared pool *without worker process restarts*:

 - **Shrink = the preemption path the job already survives.**  Moving
   worker W from job A to job B requeues W's in-flight A-tasks without
   burning retries (``TaskManager.requeue_worker_tasks``, the observer
   hand-back semantics) and removes W from A's rendezvous so A's
   survivors re-form an epoch; W itself keeps running.
 - **Grow = the registration path.**  W's next ``get_task`` routes to
   B; the response carries B's worker config (the re-assignment
   handshake, ``GetTaskResponse.job_config``) and W rebuilds its data
   pipeline/trainer in place, then joins B's world.
 - **Every decision is journaled and traced.**  Decisions are written
   ahead of their effects as ``sched`` records in the scheduler's own
   journal namespace (``<journal_dir>/sched``), so a master SIGKILLed
   mid-resize replays to a consistent schedule; each decision runs in
   a ``sched.resize`` span whose trace id is handed to the drained
   worker's re-register event (``sched.worker_reassigned``,
   ``link_trace``) so the decision and the handover stitch into ONE
   trace component on /tracez (the ``cpu_multitenant`` drill gate).

Policy (:func:`compute_targets`, pure and unit-tested): admitted jobs
with runnable work get at least their ``min_workers`` floor
(starvation-freedom; admission control refuses to over-commit the
floors, queueing jobs the pool can't fit), the surplus is split by
``weight`` with largest-remainder rounding, clamped to ``max_workers``
and to the job's runnable-task demand (utilization: never park more
workers on a job than it has tasks), and clamped leftovers re-offered
(work-conserving).  The controller applies at most
``moves_per_tick`` re-assignments per cadence so a resize drains one
worker at a time — each move its own journaled, traced decision.

See docs/scheduler.md for the protocol diagrams and knob reference.
"""

import json
import threading
import time
from collections import defaultdict, deque

from elasticdl_tpu_torch.master.journal import journal_events
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_manager import wait_task_pb
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import slo, tracing
from elasticdl_tpu_torch.utils.grpc_utils import rpc_error_guard
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.timing import Timing

logger = get_logger(__name__)

PENDING = "pending"
RUNNING = "running"
FINISHED = "finished"

# Config keys a job may carry to its workers in the re-assignment
# handshake (GetTaskResponse.job_config).  Everything else a worker
# needs stays process-level (master addr, retry policy, tracing).
WORKER_CONFIG_KEYS = (
    "model_zoo", "model_params", "data_origin", "batch_size",
    "num_minibatches_per_task", "num_epochs", "seed", "checkpoint_dir",
    "distribution_strategy",
)


class JobSpec:
    """Declarative config of one tenant job (--jobs_spec entry)."""

    def __init__(self, name, model_zoo="mnist", model_params="",
                 data_origin="synthetic_mnist", batch_size=32,
                 num_minibatches_per_task=8, num_epochs=1, seed=0,
                 shuffle=False, shuffle_shards=False, checkpoint_dir="",
                 distribution_strategy="local", min_workers=1,
                 max_workers=0, weight=1.0):
        if min_workers < 0:
            raise ValueError("min_workers must be >= 0")
        if max_workers and max_workers < min_workers:
            raise ValueError(
                "max_workers (%d) < min_workers (%d) for job %s"
                % (max_workers, min_workers, name)
            )
        if weight <= 0:
            raise ValueError("weight must be > 0")
        if distribution_strategy == "ps":
            raise ValueError(
                "multi-tenant jobs support local/collective workers; "
                "PS-mode jobs keep their own single-job master"
            )
        self.name = name
        self.model_zoo = model_zoo
        self.model_params = model_params
        self.data_origin = data_origin
        self.batch_size = int(batch_size)
        self.num_minibatches_per_task = int(num_minibatches_per_task)
        self.num_epochs = int(num_epochs)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.shuffle_shards = bool(shuffle_shards)
        self.checkpoint_dir = checkpoint_dir
        self.distribution_strategy = distribution_strategy
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.weight = float(weight)

    @property
    def records_per_task(self):
        return self.batch_size * self.num_minibatches_per_task

    @classmethod
    def from_dict(cls, d, defaults=None):
        """Build from a --jobs_spec entry; unset fields fall back to
        the master's own common args (``defaults`` Namespace) so a spec
        can be as terse as ``{"name": "a", "data_origin": "..."}``."""
        kw = {}
        fields = (
            "model_zoo", "model_params", "data_origin", "batch_size",
            "num_minibatches_per_task", "num_epochs", "seed", "shuffle",
            "shuffle_shards", "checkpoint_dir", "distribution_strategy",
        )
        for field in fields:
            if field in d:
                kw[field] = d[field]
            elif defaults is not None and hasattr(defaults, field):
                kw[field] = getattr(defaults, field)
        for field in ("min_workers", "max_workers", "weight"):
            if field in d:
                kw[field] = d[field]
        unknown = set(d) - set(fields) - {
            "name", "min_workers", "max_workers", "weight",
        }
        if unknown:
            raise ValueError(
                "unknown jobs_spec fields for job %r: %s"
                % (d.get("name"), sorted(unknown))
            )
        return cls(d["name"], **kw)

    def journal_meta(self):
        """Fingerprint for the job's journal namespace (same contract
        as the single-job master's _journal_meta): replaying a journal
        into a DIFFERENT job config would rebuild nonsense queues."""
        return {
            "job_name": self.name, "job_type": "train",
            "data_origin": self.data_origin,
            "records_per_task": self.records_per_task,
            "num_epochs": self.num_epochs, "seed": self.seed,
            "shuffle": self.shuffle,
            "shuffle_shards": self.shuffle_shards,
        }


class ManagedJob:
    """One admitted tenant: its task queue, rendezvous epoch space,
    journal namespace, and per-job servicer (telemetry aggregate +
    version/eval handling).  ``state`` transitions pending -> running
    -> finished and is mutated only under the registry lock."""

    def __init__(self, job_id, spec, task_manager, servicer,
                 rendezvous=None, journal=None):
        self.job_id = job_id
        self.spec = spec
        self.task_manager = task_manager
        self.servicer = servicer
        self.rendezvous = rendezvous
        self.journal = journal
        self.state = PENDING

    def worker_config(self):
        """The re-assignment handshake payload: everything a pool
        worker needs to rebuild its pipeline for this job."""
        cfg = {"job": self.spec.name, "job_id": self.job_id}
        for key in WORKER_CONFIG_KEYS:
            cfg[key] = getattr(self.spec, key)
        return cfg

    def demand(self):
        """Runnable-task count — the utilization cap on this job's
        worker target (no point parking more workers than tasks)."""
        counts = self.task_manager.counts()
        return counts["todo"] + counts["doing"]


def compute_targets(pool_size, jobs):
    """Pure resize policy: per-job worker targets over a shared pool.

    ``jobs``: ``[{"id", "min", "max", "weight", "demand"}]`` for the
    RUNNING jobs (``max`` 0 = unbounded).  Guarantees, in order:

     1. zero-demand jobs get 0 (their workers are reclaimable);
     2. starvation-freedom — every job with demand gets its ``min``
        floor (capped by demand); if the pool shrank below the sum of
        floors, single grants go round-robin by descending weight so
        every job still gets workers before any job gets its second;
     3. the surplus splits by weight (largest-remainder rounding),
        clamped to ``min(max, demand)``, with clamped leftovers
        re-offered to still-open jobs (work-conserving).
    """
    targets = {j["id"]: 0 for j in jobs}
    live = []
    for j in jobs:
        demand = j.get("demand", 0)
        if demand <= 0:
            continue
        cap = j.get("max") or pool_size
        cap = max(0, min(cap, demand))
        live.append({
            "id": j["id"],
            "min": max(0, min(j.get("min", 1), cap)),
            "cap": cap,
            "weight": max(float(j.get("weight", 1.0)), 1e-9),
        })
    if not live or pool_size <= 0:
        return targets
    floors = sum(j["min"] for j in live)
    if floors > pool_size:
        # Degraded pool: weighted round-robin single grants — every
        # job reaches 1 before any reaches 2, and so on up to its min.
        order = sorted(live, key=lambda j: (-j["weight"], j["id"]))
        left = pool_size
        while left > 0:
            progressed = False
            for j in order:
                if left <= 0:
                    break
                if targets[j["id"]] < j["min"]:
                    targets[j["id"]] += 1
                    left -= 1
                    progressed = True
            if not progressed:
                break
        return targets
    for j in live:
        targets[j["id"]] = j["min"]
    left = pool_size - floors
    open_jobs = [j for j in live if targets[j["id"]] < j["cap"]]
    while left > 0 and open_jobs:
        total_w = sum(j["weight"] for j in open_jobs)
        shares = []
        for j in open_jobs:
            exact = left * j["weight"] / total_w
            shares.append([j, int(exact), exact - int(exact)])
        granted = sum(s[1] for s in shares)
        for s in sorted(shares, key=lambda s: (-s[2], s[0]["id"])):
            if granted >= left:
                break
            s[1] += 1
            granted += 1
        progressed = False
        for j, add, _rem in shares:
            add = min(add, j["cap"] - targets[j["id"]])
            if add > 0:
                targets[j["id"]] += add
                left -= add
                progressed = True
        open_jobs = [j for j in open_jobs if targets[j["id"]] < j["cap"]]
        if not progressed:
            break
    return targets


class JobRegistry:
    """The scheduler's book of record: jobs, admission queue, and the
    worker->job assignment map.  Thread-safe; journal appends happen
    OUTSIDE the lock (EL006 — events are collected under the lock and
    emitted after release, the TaskManager pattern)."""

    def __init__(self, journal=None, pool_size=0):
        self._lock = threading.Lock()
        self._journal = journal
        self._jobs = {}             # job_id -> ManagedJob
        self._order = []            # submission order (admission FIFO)
        self._assignments = {}      # worker_id -> job_id
        self._last_seen = {}        # worker_id -> time.monotonic()
        self._pending_links = {}    # worker_id -> decision trace id
        self._pool_size = int(pool_size)
        self.decision_counts = defaultdict(int)
        # Scheduler decision-latency phases (ResizeController observes
        # its tick/rebalance wall time here); rendered as native
        # histograms on the multi-tenant /metrics
        # (elasticdl_sched_decision_seconds{phase=}).
        self.timing = Timing()

    # -- job lifecycle ------------------------------------------------------

    def submit(self, job, journal=True):
        """Register a job: admitted immediately when the pool can hold
        every running job's min-share floor plus this one's, queued
        (admission control) otherwise."""
        events = []
        with self._lock:
            if job.job_id in self._jobs:
                raise ValueError("duplicate job id %d" % job.job_id)
            self._jobs[job.job_id] = job
            self._order.append(job.job_id)
            if journal:
                events.append({
                    "ev": "sched", "op": "submit", "job": job.job_id,
                    "name": job.spec.name, "min": job.spec.min_workers,
                    "max": job.spec.max_workers,
                    "weight": job.spec.weight,
                })
                self.decision_counts["submit"] += 1
            queued_ahead = any(
                j.state == PENDING for j in self._jobs.values()
                if j is not job
            )
            if not queued_ahead and self._fits_locked(job):
                job.state = RUNNING
                if journal:
                    events.append({"ev": "sched", "op": "admit",
                                   "job": job.job_id})
                    self.decision_counts["admit"] += 1
            else:
                logger.info(
                    "job %s (id %d) queued: pool of %d cannot hold its "
                    "min share of %d on top of the running floors",
                    job.spec.name, job.job_id, self._pool_size_locked(),
                    job.spec.min_workers,
                )
        journal_events(self._journal, events)
        if job.state == RUNNING:
            logger.info("job %s admitted as id %d (min=%d max=%d "
                        "weight=%.2f)", job.spec.name, job.job_id,
                        job.spec.min_workers, job.spec.max_workers,
                        job.spec.weight)
        return job

    def _pool_size_locked(self):
        """Best current pool estimate: the configured size or, once
        workers have registered, however many we actually know."""
        return max(self._pool_size, len(self._last_seen))

    def _fits_locked(self, job):
        floors = sum(
            j.spec.min_workers for j in self._jobs.values()
            if j.state == RUNNING
        )
        return floors + job.spec.min_workers <= self._pool_size_locked()

    def admit_pending(self):
        """Admission sweep (controller cadence): admit queued jobs, in
        submission order, while their floors fit.  Returns them."""
        admitted = []
        events = []
        with self._lock:
            for job_id in self._order:
                job = self._jobs[job_id]
                if job.state != PENDING:
                    continue
                if not self._fits_locked(job):
                    break   # FIFO: never admit past a job that waits
                job.state = RUNNING
                events.append({"ev": "sched", "op": "admit",
                               "job": job_id})
                self.decision_counts["admit"] += 1
                admitted.append(job)
        journal_events(self._journal, events)
        for job in admitted:
            logger.info("job %s (id %d) admitted from the queue",
                        job.spec.name, job.job_id)
        return admitted

    def mark_finished(self, job_id):
        events = []
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state == FINISHED:
                return
            job.state = FINISHED
            events.append({"ev": "sched", "op": "finish",
                           "job": job_id})
            self.decision_counts["finish"] += 1
        journal_events(self._journal, events)
        logger.info("job %s (id %d) finished: %s", job.spec.name,
                    job_id, job.task_manager.counts())

    # -- lookups ------------------------------------------------------------

    def jobs(self):
        with self._lock:
            return [self._jobs[j] for j in self._order]

    def get_job(self, job_id):
        with self._lock:
            return self._jobs.get(job_id)

    def job_for_worker(self, worker_id):
        with self._lock:
            return self._jobs.get(self._assignments.get(worker_id))

    def assigned_counts(self):
        with self._lock:
            return self._assigned_counts_locked()

    def _assigned_counts_locked(self):
        counts = defaultdict(int)
        for job_id in self._assignments.values():
            counts[job_id] += 1
        return dict(counts)

    def all_finished(self):
        with self._lock:
            return bool(self._jobs) and all(
                j.state == FINISHED for j in self._jobs.values()
            )

    def pop_link(self, worker_id):
        """The resize-decision trace id stashed for this worker's
        re-register handshake (one shot)."""
        with self._lock:
            return self._pending_links.pop(worker_id, None)

    def known_worker_count(self):
        """Workers currently known to the pool (seen and not yet
        released) — the run loop's drain gate: an unmanaged pool's
        workers must each collect their exit task before the server
        goes away, or they ride a pointless outage-retry into the
        reaper."""
        with self._lock:
            return len(self._last_seen)

    def touch(self, worker_id):
        """Liveness mark for the staleness sweep from a NON-get_task
        RPC: a worker grinding one long task reports progress every
        window but may not poll get_task for minutes — progress must
        count as life or the sweep evicts a healthy worker and its
        task gets redone.  Only refreshes workers the pool still
        knows: a report straggling in after release must not re-open
        the drain gate."""
        with self._lock:
            if (
                worker_id in self._last_seen
                or worker_id in self._assignments
            ):
                self._last_seen[worker_id] = time.monotonic()

    # -- assignment ---------------------------------------------------------

    def ensure_assigned(self, worker_id):
        """Route a polling worker.  A worker that HAS an assignment
        keeps it — even to a finished job — so that every cross-job
        move goes through the controller's rate-limited, journaled,
        traced decision path (a parked worker just WAITs until its
        move lands).  A fresh worker registers immediately into the
        runnable job with the largest target deficit (registration
        drains nobody, so it is not rate limited)."""
        with self._lock:
            self._last_seen[worker_id] = time.monotonic()
            job = self._jobs.get(self._assignments.get(worker_id))
            if job is not None:
                return job
            runnable = [
                j for j in self._jobs.values() if j.state == RUNNING
            ]
            pool = self._pool_size_locked()
        if not runnable:
            return None
        # Demand reads take each TaskManager's own lock — outside ours.
        descriptors = [
            {"id": j.job_id, "min": j.spec.min_workers,
             "max": j.spec.max_workers, "weight": j.spec.weight,
             "demand": j.demand()}
            for j in runnable
        ]
        targets = compute_targets(pool, descriptors)
        events = []
        with self._lock:
            job = self._jobs.get(self._assignments.get(worker_id))
            if job is not None:
                return job   # raced another assigner; adopt its pick
            counts = self._assigned_counts_locked()
            best, best_deficit = None, None
            for j in runnable:
                deficit = (
                    targets.get(j.job_id, 0) - counts.get(j.job_id, 0)
                )
                if best is None or deficit > best_deficit:
                    best, best_deficit = j, deficit
            if best is None or best_deficit <= 0:
                # Every runnable job is at (or over) target: leave the
                # worker unassigned; it parks on WAIT and the next
                # demand shift claims it.
                job = None
            else:
                self._assignments[worker_id] = best.job_id
                events.append({"ev": "sched", "op": "assign",
                               "w": worker_id, "job": best.job_id,
                               "prev": 0})
                self.decision_counts["assign"] += 1
                job = best
        journal_events(self._journal, events)
        if job is not None:
            logger.info("worker %d registered into job %s (id %d)",
                        worker_id, job.spec.name, job.job_id)
        return job

    def commit_move(self, worker_id, to_job_id, link=None, sensors=None):
        """Write-ahead commit of one resize decision: the assignment
        flips and the ``sched`` record becomes durable BEFORE any drain
        effect runs, so a crash mid-resize replays to the post-decision
        schedule (the drain is idempotent: a restart requeues in-flight
        tasks anyway).  Returns the worker's previous job id."""
        event = {"ev": "sched", "op": "assign", "w": worker_id,
                 "job": to_job_id}
        with self._lock:
            prev = self._assignments.get(worker_id, 0)
            self._assignments[worker_id] = to_job_id
            if link:
                self._pending_links[worker_id] = link
            self.decision_counts["assign"] += 1
            event["prev"] = prev
            if sensors:
                event["sps"] = sensors
        journal_events(self._journal, [event])
        if self._journal is not None:
            # A resize decision must be durable before its effects; the
            # group-commit kick is asynchronous, so fence here (rare —
            # at most moves_per_tick per cadence).
            self._journal.flush()
        return prev

    def release_worker(self, worker_id, reason="exit"):
        """Drop a worker from the map (process exit, job finished,
        staleness eviction).  Returns its old job id or None."""
        events = []
        with self._lock:
            self._last_seen.pop(worker_id, None)
            self._pending_links.pop(worker_id, None)
            prev = self._assignments.pop(worker_id, None)
            if prev is not None:
                events.append({"ev": "sched", "op": "release",
                               "w": worker_id, "job": prev,
                               "reason": reason})
                self.decision_counts["release"] += 1
        journal_events(self._journal, events)
        return prev

    def evict_stale(self, stale_secs, now=None):
        """Workers that have not polled within ``stale_secs`` are
        presumed gone (a restarted master replays assignments for
        workers that may never return): release them so the policy
        stops counting ghosts.  Returns [(worker_id, job_id)]."""
        now = time.monotonic() if now is None else now
        with self._lock:
            stale = [
                w for w, seen in self._last_seen.items()
                if now - seen > stale_secs
            ]
        evicted = []
        for worker_id in stale:
            prev = self.release_worker(worker_id, reason="stale")
            evicted.append((worker_id, prev))
            logger.warning(
                "worker %d evicted from the scheduler pool (silent for "
                "> %.0fs; was on job %s)", worker_id, stale_secs, prev,
            )
        return evicted

    # -- crash-restart recovery --------------------------------------------

    def restore_from_journal(self, state):
        """Rebuild the schedule a crashed master had made durable: job
        admission states and the worker->job assignment map (sched
        records are written ahead of their effects, so the replayed map
        IS the committed schedule).  Restored workers get a fresh
        last-seen stamp — they are expected to reconnect; the staleness
        sweep reclaims the ones that never do."""
        now = time.monotonic()
        with self._lock:
            for job_id, info in state.sched_jobs.items():
                job = self._jobs.get(int(job_id))
                if job is None:
                    logger.warning(
                        "journal names job id %s absent from "
                        "--jobs_spec; ignoring", job_id,
                    )
                    continue
                job.state = info.get("state", PENDING)
            for worker_id, job_id in state.sched_assignments.items():
                if int(job_id) in self._jobs:
                    self._assignments[int(worker_id)] = int(job_id)
                    self._last_seen[int(worker_id)] = now
            for op, n in state.sched_decisions.items():
                self.decision_counts[op] += n
            restored = {
                "assignments": dict(self._assignments),
                "jobs": {
                    j.job_id: j.state for j in self._jobs.values()
                },
            }
        logger.warning(
            "master restart: schedule restored from journal: %s",
            restored,
        )

    # -- observability ------------------------------------------------------

    def status(self):
        """Copy-safe scheduler snapshot for /status and /metrics."""
        with self._lock:
            jobs = [self._jobs[j] for j in self._order]
            assignments = dict(self._assignments)
            counts = self._assigned_counts_locked()
            decisions = dict(self.decision_counts)
            pool = self._pool_size_locked()
            known = len(self._last_seen)
        return {
            "pool_workers": pool,
            "known_workers": known,
            "pending_jobs": sum(1 for j in jobs if j.state == PENDING),
            "decisions": decisions,
            "assignments": {
                str(w): j for w, j in sorted(assignments.items())
            },
            "workers_assigned": {
                j.spec.name: counts.get(j.job_id, 0) for j in jobs
            },
            "hists": self.timing.histograms(),
        }


class ResizeController:
    """The policy loop: every ``cadence_secs`` it sweeps finished jobs,
    evicts silent workers, admits queued jobs, recomputes targets from
    the registry + the PR-10 telemetry aggregates, and applies at most
    ``moves_per_tick`` worker re-assignments — each journaled write-
    ahead and wrapped in a ``sched.resize`` span whose trace links to
    the drained worker's re-register (docs/scheduler.md)."""

    def __init__(self, registry, worker_manager=None, cadence_secs=1.0,
                 moves_per_tick=1, worker_stale_secs=300.0):
        self._registry = registry
        self._worker_manager = worker_manager
        self._cadence = max(0.1, float(cadence_secs))
        self._moves_per_tick = max(1, int(moves_per_tick))
        self._worker_stale_secs = float(worker_stale_secs)
        self._stopped = threading.Event()
        self._thread = None
        # Sustained stragglers as of the last sweep (tick-thread
        # state): the DEWEIGHT policy term — when a shrink must pick
        # donors from an over-target job, flagged stragglers go first
        # (moving one costs the donor job its slowest member).
        self._stragglers = set()

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="sched-controller", daemon=True,
        )
        self._thread.start()

    def stop(self):
        """Stop the loop and JOIN a mid-tick thread (bounded): the
        caller closes the journals right after, and a straggling
        commit_move must not race the close — its write-ahead record
        would be silently dropped while the in-memory flip applied."""
        self._stopped.set()
        thread = self._thread
        if (
            thread is not None and thread.is_alive()
            and thread is not threading.current_thread()
        ):
            thread.join(timeout=10)

    def _loop(self):
        while not self._stopped.wait(timeout=self._cadence):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the policy loop
                # must outlive a bad tick (a job torn down mid-snapshot
                # etc.); scheduling resumes on the next cadence.
                logger.exception("resize controller tick failed: %s", e)

    # -- one cadence --------------------------------------------------------

    def tick(self):
        """One policy pass; synchronous and re-entrant-safe, so tests
        drive it directly without the thread.  Wall time feeds the
        scheduler decision-latency histogram
        (elasticdl_sched_decision_seconds{phase="tick"})."""
        t0 = time.perf_counter()
        try:
            return self._tick()
        finally:
            self._registry.timing.observe(
                "tick", time.perf_counter() - t0)

    def _tick(self):
        jobs = self._registry.jobs()
        for job in jobs:
            if job.state == RUNNING and job.task_manager.finished():
                self._registry.mark_finished(job.job_id)
        for worker_id, job_id in self._registry.evict_stale(
            self._worker_stale_secs
        ):
            job = self._registry.get_job(job_id) if job_id else None
            if job is not None:
                # Unknown fate: requeue without burning retries (the
                # same semantics as a master-restart requeue).
                job.task_manager.requeue_worker_tasks(worker_id)
                if job.rendezvous is not None:
                    job.rendezvous.remove_worker(
                        "worker-%d" % worker_id
                    )
        # Straggler sweep (docs/observability.md): each running job's
        # servicer differences its per-worker step-time histograms
        # against the previous sweep — the controller tick IS the
        # sweep cadence, so a deliberately slow worker is flagged
        # within one cadence of reporting skewed deltas.
        stragglers = set()
        for job in self._registry.jobs():
            if job.state == RUNNING:
                stragglers.update(job.servicer.straggler_sweep())
        self._stragglers = stragglers
        # SLO watchdog rides the policy cadence: breaches (e.g. the
        # default straggler rule) land in the flight recorder the
        # moment the sweep that caused them ran — /alertz reads are
        # then a view, not the trigger.
        if slo.default_watchdog().rule_count:
            slo.default_watchdog().evaluate()
        self._registry.admit_pending()
        return self._rebalance()

    def _rebalance(self):
        # ONE registry snapshot per tick: pool estimate, assignment
        # map and per-job counts all come from the same lock
        # acquisition, so donors/receivers are computed against a
        # coherent schedule (a racing registration lands next tick).
        status = self._registry.status()
        jobs = self._registry.jobs()
        running = [j for j in jobs if j.state == RUNNING]
        finished_ids = {j.job_id for j in jobs if j.state == FINISHED}
        if not running:
            return []
        if self._worker_manager is not None:
            # The manager sees deaths before the staleness sweep does.
            pool_size = len(self._worker_manager.live_worker_ids())
        else:
            pool_size = status["pool_workers"]
        assignments = {
            int(w): j for w, j in status["assignments"].items()
        }
        counts = defaultdict(int)
        for job_id in assignments.values():
            counts[job_id] += 1
        # Demand reads take each TaskManager's own lock — after the
        # registry snapshot, never inside it.
        descriptors = [
            {"id": j.job_id, "min": j.spec.min_workers,
             "max": j.spec.max_workers, "weight": j.spec.weight,
             "demand": j.demand()}
            for j in running
        ]
        targets = compute_targets(pool_size, descriptors)
        # Donors: workers parked on finished jobs first (pure reclaim),
        # then workers on over-target jobs (newest first — they hold
        # the least warmed-up state).
        donors = deque(sorted(
            (w for w, j in assignments.items() if j in finished_ids),
            reverse=True,
        ))
        over = []
        for job in running:
            excess = counts.get(job.job_id, 0) - targets.get(
                job.job_id, 0
            )
            if excess > 0:
                # Straggler deweight: a sustained straggler is the
                # preferred donor (the donor job sheds its slowest
                # member), then newest-first as before.
                owned = sorted(
                    (w for w, j in assignments.items()
                     if j == job.job_id),
                    key=lambda w: (w not in self._stragglers, -w),
                )
                over.extend(owned[:excess])
        donors.extend(sorted(
            over, key=lambda w: (w not in self._stragglers, -w)))
        receivers = sorted(
            (j for j in running
             if targets.get(j.job_id, 0) > counts.get(j.job_id, 0)),
            key=lambda j: (
                counts.get(j.job_id, 0) - targets.get(j.job_id, 0)
            ),
        )
        moves = []
        budget = self._moves_per_tick
        for job in receivers:
            deficit = targets.get(job.job_id, 0) - counts.get(
                job.job_id, 0
            )
            while deficit > 0 and donors and budget > 0:
                worker_id = donors.popleft()
                from_id = assignments.get(worker_id)
                if from_id == job.job_id:
                    continue
                self._apply_move(worker_id, from_id, job)
                moves.append((worker_id, from_id, job.job_id))
                deficit -= 1
                budget -= 1
            if budget <= 0:
                break
        return moves

    def _sensor_reading(self, job):
        """The PR-10 telemetry aggregate this decision saw — recorded
        on the decision span and in the journal record so an operator
        can audit WHY the controller moved a worker."""
        if job is None:
            return None
        telemetry = job.servicer.telemetry()["job"]
        return {
            "steps_per_sec": telemetry["steps_per_sec"],
            "workers_reporting": telemetry["workers_reporting"],
        }

    def _apply_move(self, worker_id, from_job_id, to_job):
        """One journaled, traced re-assignment: decision durable first
        (write-ahead), then the drain — requeue the worker's in-flight
        tasks in its old job without burning retries and re-form the
        old job's rendezvous epoch.  The worker itself learns of the
        move on its next ``get_task`` (the handshake)."""
        from_job = (
            self._registry.get_job(from_job_id) if from_job_id else None
        )
        sensors = {}
        reading = self._sensor_reading(from_job)
        if reading is not None:
            sensors["from"] = reading
        reading = self._sensor_reading(to_job)
        if reading is not None:
            sensors["to"] = reading
        with tracing.span(
            "sched.resize", worker=worker_id,
            from_job=from_job_id or 0, to_job=to_job.job_id,
            sensors=sensors,
        ) as decision:
            self._registry.commit_move(
                worker_id, to_job.job_id,
                link=getattr(decision, "trace", None),
                sensors=sensors or None,
            )
            requeued = []
            if from_job is not None:
                requeued = from_job.task_manager.requeue_worker_tasks(
                    worker_id
                )
                if from_job.rendezvous is not None:
                    from_job.rendezvous.remove_worker(
                        "worker-%d" % worker_id
                    )
            logger.info(
                "resize: worker %d moved %s -> %s (%d task(s) "
                "requeued)", worker_id,
                from_job.spec.name if from_job else "<pool>",
                to_job.spec.name, len(requeued),
            )


class MultiTenantServicer:
    """The master's RPC surface when J jobs share the pool: every
    method routes to the owning job's :class:`MasterServicer`.  Tasks
    and reports are job-scoped (``job_id`` proto fields) because task
    ids are only unique per job — a result reported after its worker
    moved jobs still lands on the job that dispatched it.  The
    ``get_task`` response doubles as the re-assignment handshake."""

    def __init__(self, registry):
        self._registry = registry

    @rpc_error_guard
    def get_task(self, request, _context=None):
        job = self._registry.ensure_assigned(request.worker_id)
        if job is None:
            res = self._pool_answer()
            if res.task.type != pb.WAIT:
                # Exit handed to an UNASSIGNED worker (pool larger
                # than total demand): drop it from the known set too,
                # or the drain gate would hold the run loop for the
                # full grace window on a worker that already left.
                self._registry.release_worker(
                    request.worker_id, reason="pool_done"
                )
            return res
        res = job.servicer.get_task(request, _context)
        if res.task.id < 0 and res.task.type != pb.WAIT:
            # The assigned job is finished.  The worker exits only when
            # EVERY job (queued ones included) is done; otherwise it
            # PARKS on its current assignment — the controller reclaims
            # it with a rate-limited, journaled, traced move, so a
            # resize is never a silent servicer-side side effect.
            if self._registry.all_finished():
                self._registry.release_worker(
                    request.worker_id, reason="job_finished"
                )
                return self._pool_answer()
            res = pb.GetTaskResponse()
            res.task.CopyFrom(wait_task_pb())
            # Fall through to the handshake: a move whose target job
            # drained before this worker's first post-move poll must
            # STILL deliver the config and pop the decision link —
            # else the client adopts the new job id with the old
            # pipeline and the decision trace never stitches.
        return self._handshake(res, job, request)

    def _handshake(self, res, job, request):
        """Stamp the assignment on the response; when it changed since
        the job id the worker echoed, ship the job's config and link
        this re-register to the resize decision that caused it
        (sched.resize span trace) so decision and handover stitch into
        one trace component."""
        res.job_id = job.job_id
        if res.task.id > 0:
            res.task.job_id = job.job_id
        if request.job_id != job.job_id:
            res.job_config = json.dumps(job.worker_config())
            attrs = {"worker": request.worker_id, "job": job.job_id,
                     "prev_job": request.job_id}
            link = self._registry.pop_link(request.worker_id)
            if link:
                attrs["link_trace"] = link
            tracing.event("sched.worker_reassigned", **attrs)
            logger.info(
                "worker %d handshake: job %d -> %d (%s)",
                request.worker_id, request.job_id, job.job_id,
                job.spec.name,
            )
        return res

    def _pool_answer(self):
        """WAIT while any job might still produce work; exit otherwise."""
        res = pb.GetTaskResponse()
        if self._registry.all_finished():
            res.task.id = -1
            res.task.type = pb.TRAINING
        else:
            res.task.CopyFrom(wait_task_pb())
        return res

    def _job_by_id(self, job_id, what):
        job = self._registry.get_job(job_id) if job_id else None
        if job is None:
            logger.warning(
                "%s for unknown job %d dropped (multi-tenant reports "
                "must carry the owning job id)", what, job_id,
            )
        return job

    @rpc_error_guard
    def report_task_result(self, request, _context=None):
        job = self._job_by_id(request.job_id, "task result")
        if job is None:
            return pb.Empty()
        return job.servicer.report_task_result(request, _context)

    @rpc_error_guard
    def report_batch_done(self, request, _context=None):
        # Progress is liveness: a worker grinding one long task may
        # not poll get_task for minutes, and the staleness sweep must
        # not evict it mid-task.
        self._registry.touch(request.worker_id)
        job = self._registry.get_job(request.job_id)
        if job is None:
            # Legacy/unscoped progress: fall back to the worker's
            # current assignment (correct except across an in-flight
            # re-assignment, which scoped reports exist to close).
            job = self._registry.job_for_worker(request.worker_id)
        if job is None:
            logger.warning(
                "progress report from unassigned worker %d dropped",
                request.worker_id,
            )
            return pb.Empty()
        return job.servicer.report_batch_done(request, _context)

    @rpc_error_guard
    def get_comm_rank(self, request, _context=None):
        job = self._registry.get_job(request.job_id)
        if job is None or job.rendezvous is None:
            res = pb.GetCommRankResponse()
            res.rank_id = -1
            return res
        return job.servicer.get_comm_rank(request, _context)

    @rpc_error_guard
    def report_train_loop_status(self, request, _context=None):
        job = self._registry.get_job(request.job_id)
        if job is None:
            return pb.Empty()
        return job.servicer.report_train_loop_status(request, _context)

    @rpc_error_guard
    def report_evaluation_metrics(self, request, _context=None):
        # Liveness, like report_batch_done: an EVALUATION task reports
        # metrics per minibatch but no record counts.
        self._registry.touch(request.worker_id)
        job = self._job_by_id(request.job_id, "evaluation metrics")
        if job is None:
            return pb.Empty()
        return job.servicer.report_evaluation_metrics(request, _context)

    @rpc_error_guard
    def report_version(self, request, _context=None):
        job = self._job_by_id(request.job_id, "version report")
        if job is None:
            return pb.Empty()
        return job.servicer.report_version(request, _context)

    @rpc_error_guard
    def report_training_params(self, request, _context=None):
        job = self._job_by_id(request.job_id, "training params")
        if job is None:
            return pb.Empty()
        return job.servicer.report_training_params(request, _context)


class MultiTenantMaster:
    """Composition root for the multi-tenant control plane: the shared
    gRPC service, the worker pool, the registry, and the policy loop.
    The single-job :class:`~elasticdl_tpu_torch.master.master.Master` is
    untouched — ``--jobs_spec`` selects this instead (master/main)."""

    def __init__(self, registry, controller, worker_manager=None,
                 port=0, poll_secs=1.0, sched_journal=None,
                 interceptors=None):
        self.registry = registry
        self.controller = controller
        self.worker_manager = worker_manager
        self.sched_journal = sched_journal
        self._port = port
        self._poll_secs = poll_secs
        self._interceptors = interceptors
        self._server = None
        self.port = None
        self._stop_requested = threading.Event()
        self.servicer = MultiTenantServicer(registry)

    def prepare(self):
        from elasticdl_tpu_torch.master.servicer import create_master_service

        for job in self.registry.jobs():
            job.task_manager.add_worker_timeout_callback(
                self._on_worker_timeout
            )
            job.task_manager.start()
        if self.worker_manager is not None:
            self.worker_manager.add_exit_callback(self._on_worker_exit)
        self._server, self.port = create_master_service(
            self.servicer, port=self._port,
            interceptors=self._interceptors,
        )
        if self.worker_manager is not None:
            self.worker_manager.set_master_addr("localhost:%d"
                                                % self.port)
            self.worker_manager.start()
        self.controller.start()

    def _on_worker_exit(self, worker_id, _should_relaunch):
        job_id = self.registry.release_worker(worker_id, reason="exit")
        job = self.registry.get_job(job_id) if job_id else None
        if job is not None:
            # A dead worker's failure burns retries (it may have
            # poisoned the task) — the single-job semantics.
            job.task_manager.recover_tasks(worker_id)
            if job.rendezvous is not None:
                job.rendezvous.remove_worker("worker-%d" % worker_id)

    def _on_worker_timeout(self, worker_id):
        if self.worker_manager is not None:
            self.worker_manager.remove_worker(worker_id)
        job = self.registry.job_for_worker(worker_id)
        if job is not None and job.rendezvous is not None:
            job.rendezvous.remove_worker("worker-%d" % worker_id)

    # After every job finished, an UNMANAGED pool (workers launched by
    # a previous incarnation or externally) gets this long for each
    # worker to poll once more and collect its exit task before the
    # server goes away — without it, parked workers would ride a
    # pointless outage-retry against a dead port.
    DRAIN_GRACE_SECS = 20.0

    def run(self):
        """Block until every job (admitted and queued) has finished
        and the pool workers have drained — or until the managed pool
        is permanently dead with work remaining (exit 1, the
        single-job Master.run semantics)."""
        drain_deadline = None
        stalled_polls = 0
        try:
            while not self._stop_requested.is_set():
                if self.registry.all_finished():
                    if self.worker_manager is not None:
                        if self.worker_manager.all_workers_exited():
                            break
                    elif self.registry.known_worker_count() == 0:
                        break
                    else:
                        if drain_deadline is None:
                            drain_deadline = (
                                time.monotonic()
                                + self.DRAIN_GRACE_SECS
                            )
                        if time.monotonic() > drain_deadline:
                            logger.warning(
                                "pool drain grace expired with %d "
                                "worker(s) still registered; exiting",
                                self.registry.known_worker_count(),
                            )
                            break
                elif (
                    self.worker_manager is not None
                    and self.worker_manager.all_workers_done()
                ):
                    # Same consecutive-observation rule as the
                    # single-job master: a watcher thread may not have
                    # processed a fresh exit yet.
                    stalled_polls += 1
                    if stalled_polls >= 3:
                        logger.error(
                            "all pool workers failed permanently with "
                            "jobs unfinished: %s",
                            {j.spec.name: j.task_manager.counts()
                             for j in self.registry.jobs()},
                        )
                        return 1
                else:
                    stalled_polls = 0
                time.sleep(self._poll_secs)
        finally:
            self.stop()
        lost = 0
        summary = {}
        for job in self.registry.jobs():
            counts = job.task_manager.counts()
            failed = sum(counts["failed"].values())
            lost += failed
            summary[job.spec.name] = counts
        if lost:
            logger.error(
                "multi-tenant run finished with %d permanently failed "
                "task(s): %s", lost, summary,
            )
            return 1
        logger.info("all jobs finished: %s", summary)
        return 0

    def stop(self):
        self._stop_requested.set()
        self.controller.stop()
        for job in self.registry.jobs():
            job.task_manager.stop()
        if self.worker_manager is not None:
            self.worker_manager.stop()
        if self._server is not None:
            self._server.stop(grace=1)
            self._server = None
        if self.sched_journal is not None:
            self.sched_journal.flush()
