"""Master gRPC servicer.

Implements the control-plane RPCs (parity with
elasticdl/python/master/servicer.py:61-198): task dispatch with WAIT-task
logic for idle workers, task result accounting, rendezvous rank queries,
train-loop membership, evaluation metric ingestion and version reports.
"""

import functools
import threading
import time

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.proto import rpc
from elasticdl_tpu_torch.utils import grpc_utils, tensor_codec, tracing
from elasticdl_tpu_torch.utils import hist as hist_mod
from elasticdl_tpu_torch.utils.grpc_utils import rpc_error_guard
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.master.task_manager import wait_task_pb

logger = get_logger(__name__)


def _timed_rpc(method):
    """Feed each handled RPC's wall time into the servicer's Timing —
    behind the mean sits a histogram (utils/hist.py), so the master's
    RPC handle time is a real p99 on /metrics
    (elasticdl_master_rpc_handle_seconds{method=}).  Durations are
    measured with local starts (concurrent handler threads — the
    shared timeit starts dict would corrupt)."""
    name = "rpc." + method.__name__

    @functools.wraps(method)
    def wrapper(self, request, _context=None):
        t0 = time.perf_counter()
        try:
            return method(self, request, _context)
        finally:
            self.timing.observe(name, time.perf_counter() - t0)

    return wrapper


class MasterServicer:
    def __init__(
        self,
        task_manager,
        rendezvous_server=None,
        evaluation_service=None,
        worker_manager=None,
        journal=None,
        job_id=0,
    ):
        # Multi-tenant scheduler (master/scheduler.py): each admitted
        # job gets its OWN MasterServicer, so the per-worker telemetry
        # aggregation below is keyed per job by construction — two
        # jobs' workers can never collide in one aggregate.  ``job_id``
        # makes a misroute loud instead of silent: a progress report
        # stamped for a different job is dropped, never folded in.
        # 0 = the single-job master (job scoping off).
        self._job_id = job_id
        self._task_manager = task_manager
        self._rendezvous = rendezvous_server
        self._evaluation_service = evaluation_service
        self._worker_manager = worker_manager
        self._lock = threading.Lock()
        # Progress events stream to the job journal BUFFERED (they are
        # the hot path; a crash loses at most one flush window of
        # observability counts — task accounting is exact).  Appends
        # run outside self._lock (EL006).
        self._journal = journal
        self._version = 0
        self.training_params = None
        self.worker_record_counts = {}  # worker_id -> records processed
        self.worker_exec_counters = {}  # counter name -> total
        # Per-worker live training telemetry piggybacked on the
        # coalesced progress RPCs (docs/observability.md): worker_id ->
        # {steps_per_sec, sync_fraction, push_staleness, window_size,
        # steps_done, age}.  The per-job aggregate over these series is
        # the sensor input the multi-tenant resize controller (ROADMAP
        # item 5) reads from /status and /metrics.
        self.worker_telemetry = {}
        # Handle-time phases for the hot control-plane RPCs
        # (_timed_rpc); .histograms() renders on /metrics.
        self.timing = Timing()
        # Per-worker / per-job step-time distributions: EXACT merges
        # of the sparse histogram deltas workers piggyback on progress
        # RPCs (utils/hist.py fixed bounds — true p50/p99, not means
        # of means), plus the straggler detector's sweep state
        # (docs/observability.md).  All under self._lock.
        self.worker_step_hist = {}     # worker_id -> snapshot dict
        self.job_step_hist = hist_mod.empty_snapshot()
        self._straggler_prev = {}      # worker_id -> snapshot at sweep
        self._straggler_state = {}     # worker_id -> {"flagged": n,
        #                                "p50_ms": x, "ratio": r}
        # PS recovery state from generation-tagged version reports
        # (docs/ps_recovery.md): ps_id -> {generation, version,
        # durable_version}.  Observability only (status page, drills);
        # not journaled — a restarted master re-learns it from the next
        # cadence of reports.
        self.ps_shard_state = {}

    def restore_from_journal(self, state):
        """Master restart: resume the version high-water mark and the
        per-worker progress counts from the replayed journal."""
        with self._lock:
            self._version = max(self._version, state.model_version)
            for worker_id, n in state.worker_records.items():
                self.worker_record_counts[worker_id] = n

    @property
    def model_version(self):
        with self._lock:
            return self._version

    # -- task dispatch ------------------------------------------------------

    @rpc_error_guard
    @_timed_rpc
    def get_task(self, request, _context=None):
        res = pb.GetTaskResponse()
        task = self._task_manager.get(request.worker_id)
        if task is not None:
            task.to_pb(out=res.task)
            return res
        if not self._task_manager.finished():
            # Work may reappear (retries, new epochs, eval jobs): park the
            # worker instead of letting it exit.
            res.task.CopyFrom(wait_task_pb())
        else:
            res.task.id = -1
            res.task.type = pb.TRAINING  # no more work: worker exits
        return res

    @rpc_error_guard
    @_timed_rpc
    def report_task_result(self, request, _context=None):
        success = not request.err_message
        if request.exec_counters:
            # job-level execution counters piggybacked on task reports
            # (reference data_shard_service.py:100-109)
            with self._lock:
                for name, value in request.exec_counters.items():
                    self.worker_exec_counters[name] = max(
                        self.worker_exec_counters.get(name, 0), value
                    )
        result = self._task_manager.report(
            request.task_id, success, request.err_message,
            requeue=request.requeue,
        )
        # Flight-recorder breadcrumbs in the CALLER's trace (the server
        # span set by TraceServerInterceptor): a drill can follow one
        # task from dispatch through its completion/re-queue across the
        # worker and master rings.
        if success:
            tracing.event("task.completed", task=request.task_id)
        elif request.requeue:
            tracing.event("task.requeued", task=request.task_id)
        else:
            tracing.event("task.fail_reported", task=request.task_id,
                          error=request.err_message[:200])
        if (
            self._evaluation_service is not None
            and result.task is not None
            and result.task.type == pb.EVALUATION
            # A permanently-failed eval task must still count toward job
            # completion, or one bad shard wedges evaluation forever.
            and (result.ok or result.permanent_failure)
        ):
            self._evaluation_service.complete_task(
                model_version=result.task.model_version
            )
        return pb.Empty()

    @rpc_error_guard
    @_timed_rpc
    def report_batch_done(self, request, _context=None):
        if self._job_id and request.job_id and (
            request.job_id != self._job_id
        ):
            # A shared-pool worker's progress report for a DIFFERENT
            # job: counting its records (or its steps/s telemetry)
            # here would corrupt this job's aggregate — the exact
            # collision the job-scoped proto fields exist to prevent.
            logger.warning(
                "progress report for job %d dropped by job %d's "
                "servicer (routing bug upstream?)",
                request.job_id, self._job_id,
            )
            return pb.Empty()
        with self._lock:
            prev = self.worker_record_counts.get(request.worker_id, 0)
            self.worker_record_counts[request.worker_id] = (
                prev + request.record_count
            )
            if request.steps_done > 0:
                # Telemetry rides the progress report (proto fields
                # 3-7); absent fields decode as 0 — a worker predating
                # the telemetry piggyback just never lands here.
                now = time.time()
                self.worker_telemetry[request.worker_id] = {
                    "steps_per_sec": request.steps_per_sec,
                    "sync_fraction": request.sync_fraction,
                    "push_staleness": request.push_staleness,
                    "window_size": request.window_size,
                    "steps_done": request.steps_done,
                    "ts": now,
                }
                # Bound the dict even when nothing polls telemetry()
                # (--status_port off is the default): past a generous
                # live-worker count, drop long-dead entries here too.
                if len(self.worker_telemetry) > 64:
                    cutoff = now - self.TELEMETRY_EVICT_SECS
                    for worker_id in [
                        w for w, t in self.worker_telemetry.items()
                        if t["ts"] < cutoff
                    ]:
                        del self.worker_telemetry[worker_id]
                        # Step-hist state rides the same eviction: a
                        # long-dead worker's distribution stays summed
                        # into the JOB histogram (history is history)
                        # but leaves the per-worker views.
                        self.worker_step_hist.pop(worker_id, None)
                        self._straggler_prev.pop(worker_id, None)
                        self._straggler_state.pop(worker_id, None)
            if request.hist_delta:
                # Compact per-worker histogram deltas piggybacked on
                # the progress report (utils/hist.py sparse encoding;
                # fixed shared bucket bounds make the merge EXACT):
                # per-worker accumulators feed the straggler sweep,
                # the per-job accumulator feeds the true p50/p99 step
                # time on /status and /metrics.
                deltas = hist_mod.decode_deltas(request.hist_delta)
                step = deltas.get("step_time")
                if step is not None:
                    acc = self.worker_step_hist.setdefault(
                        request.worker_id, hist_mod.empty_snapshot())
                    hist_mod.merge_delta(acc, step)
                    hist_mod.merge_delta(self.job_step_hist, step)
        if self._journal is not None:
            self._journal.append(
                {"ev": "batch", "w": request.worker_id,
                 "n": request.record_count}
            )
        return pb.Empty()

    # -- rendezvous ---------------------------------------------------------

    @rpc_error_guard
    def get_comm_rank(self, request, _context=None):
        res = pb.GetCommRankResponse()
        if self._rendezvous is None:
            res.rank_id = -1
            return res
        rank, size, rdzv_id, coord = self._rendezvous.get_comm_rank(
            request.worker_host
        )
        res.rank_id = rank
        res.world_size = size
        res.rendezvous_id = rdzv_id
        res.coordinator_addr = coord
        return res

    @rpc_error_guard
    def report_train_loop_status(self, request, _context=None):
        if self._rendezvous is not None:
            if request.status == pb.LOOP_START:
                self._rendezvous.add_worker(request.worker_host)
            elif request.status == pb.LOOP_END:
                self._rendezvous.remove_worker(request.worker_host)
        return pb.Empty()

    # -- evaluation / versions ---------------------------------------------

    @rpc_error_guard
    def report_evaluation_metrics(self, request, _context=None):
        if self._evaluation_service is not None:
            outputs = {
                k: tensor_codec.pb_to_ndarray(v)
                for k, v in request.model_outputs.items()
            }
            labels = tensor_codec.pb_to_ndarray(request.labels)
            if len(outputs) == 1:
                outputs = next(iter(outputs.values()))
            self._evaluation_service.report_evaluation_metrics(
                outputs, labels,
                model_version=request.model_version,
            )
        return pb.Empty()

    # A worker whose last telemetry report is older than this is
    # excluded from the JOB aggregate (it is preempted, finished, or
    # mid-outage — summing its stale steps/s would overstate the job),
    # but stays in the per-worker view with its age visible ...
    TELEMETRY_STALE_SECS = 60.0
    # ... until this much older, when the entry is EVICTED outright:
    # a long elastic job churns through ever-new worker ids, and
    # without eviction both the dict and the /status payload grow
    # without bound while exporting hours-dead workers' last values.
    TELEMETRY_EVICT_SECS = 900.0

    def telemetry(self, now=None):
        """Copy-safe per-worker + per-job telemetry aggregate: the
        resize-controller sensor surface (/status "telemetry" section,
        /metrics elasticdl_job_steps_per_sec et al).  Includes the
        percentile plane: per-worker straggler flags + recent step
        p50, and the per-job step-time histogram (exact merge of the
        piggybacked worker deltas)."""
        now = time.time() if now is None else now
        with self._lock:
            dead = [
                worker_id
                for worker_id, t in self.worker_telemetry.items()
                if now - t["ts"] > self.TELEMETRY_EVICT_SECS
            ]
            for worker_id in dead:
                del self.worker_telemetry[worker_id]
                self.worker_step_hist.pop(worker_id, None)
                self._straggler_prev.pop(worker_id, None)
                self._straggler_state.pop(worker_id, None)
            workers = {
                worker_id: dict(t)
                for worker_id, t in self.worker_telemetry.items()
            }
            straggler = {
                worker_id: dict(s)
                for worker_id, s in self._straggler_state.items()
            }
            job_hist = dict(self.job_step_hist,
                            counts=list(self.job_step_hist["counts"]))
        live_rate = 0.0
        reporting = 0
        for worker_id, t in workers.items():
            t["age_secs"] = round(now - t.pop("ts"), 3)
            t["fresh"] = t["age_secs"] <= self.TELEMETRY_STALE_SECS
            if t["fresh"]:
                reporting += 1
                live_rate += t["steps_per_sec"]
            s = straggler.get(worker_id)
            if s is not None:
                t["straggler"] = (
                    s["flagged"] >= self.STRAGGLER_SUSTAIN_SWEEPS
                )
                if s.get("p50_ms") is not None:
                    t["step_p50_ms"] = round(s["p50_ms"], 3)
        job = {
            "steps_per_sec": round(live_rate, 3),
            "workers_reporting": reporting,
        }
        if job_hist["count"] > 0:
            p50 = hist_mod.quantile(job_hist, 0.5)
            p99 = hist_mod.quantile(job_hist, 0.99)
            job["step_hist"] = job_hist
            job["step_time_p50_ms"] = round(1e3 * p50, 3)
            job["step_time_p99_ms"] = round(1e3 * p99, 3)
        return {
            "workers": workers,
            "job": job,
        }

    def rpc_histograms(self):
        """{method: snapshot} of the handled-RPC wall-time histograms
        (_timed_rpc phases, "rpc." prefix stripped for the label)."""
        return {
            name[len("rpc."):]: snap
            for name, snap in self.timing.histograms().items()
            if name.startswith("rpc.")
        }

    # -- straggler detection -------------------------------------------------

    # A worker needs this many step samples in a sweep window to be
    # judged at all (a worker between tasks must not read as "fast"
    # or "slow" off two samples)...
    STRAGGLER_MIN_SAMPLES = 4
    # ... is FLAGGED when its windowed p50 step time exceeds this
    # multiple of the cross-worker median ...
    STRAGGLER_RATIO = 2.0
    # ... and is a sustained STRAGGLER once flagged in this many
    # CONSECUTIVE sweeps (one slow window — a GC pause, a checkpoint —
    # must not trigger policy).
    STRAGGLER_SUSTAIN_SWEEPS = 2

    def straggler_sweep(self, now=None):
        """One detector pass over the per-worker step-time deltas
        since the previous sweep: computes each reporting worker's
        windowed p50, compares against the cross-worker median, and
        updates consecutive-flag counts.  Returns the worker ids that
        are SUSTAINED stragglers right now.  Called at the resize
        controller's cadence (and by tests directly); needs >= 2
        workers with enough samples — skew is relative by definition.

        A newly sustained straggler emits a ``worker.straggler``
        flight-recorder event; policy (deweight / evict) lives in the
        ResizeController, which treats the returned set as preferred
        donors (docs/scheduler.md)."""
        newly = []
        with self._lock:
            p50s = {}
            for worker_id, acc in self.worker_step_hist.items():
                prev = self._straggler_prev.get(worker_id)
                d = hist_mod.delta(acc, prev)
                if d["count"] < self.STRAGGLER_MIN_SAMPLES:
                    # Below the judgement floor: do NOT rotate the
                    # mark — the window keeps accumulating until it
                    # holds enough samples.  (Rotating every sweep
                    # made any worker slower than MIN_SAMPLES/cadence
                    # steps per sweep permanently unjudgeable — and a
                    # straggler is by definition slow.)
                    continue
                self._straggler_prev[worker_id] = dict(
                    acc, counts=list(acc["counts"]))
                window = hist_mod.empty_snapshot()
                hist_mod.merge_delta(window, d)
                p50s[worker_id] = hist_mod.quantile(window, 0.5)
            for worker_id, p50 in p50s.items():
                # LEAVE-ONE-OUT median: each worker is judged against
                # the median of the OTHERS.  A plain all-workers
                # median caps the reachable ratio at 2.0 in a
                # two-worker job (the slow worker drags the median up
                # toward itself), making small jobs' stragglers
                # undetectable by construction.
                others = sorted(p for w, p in p50s.items()
                                if w != worker_id)
                if not others:
                    continue
                mid = len(others) // 2
                median = (others[mid] if len(others) % 2
                          else (others[mid - 1] + others[mid]) / 2.0)
                state = self._straggler_state.setdefault(
                    worker_id, {"flagged": 0, "p50_ms": None,
                                "ratio": None})
                state["p50_ms"] = 1e3 * p50
                if median > 0:
                    state["ratio"] = p50 / median
                    if p50 > self.STRAGGLER_RATIO * median:
                        state["flagged"] += 1
                        if state["flagged"] == (
                                self.STRAGGLER_SUSTAIN_SWEEPS):
                            newly.append(
                                (worker_id, state["ratio"]))
                    else:
                        state["flagged"] = 0
            # Workers that reported nothing this window keep their
            # count (a stalled straggler must not un-flag by going
            # silent — silence is the stale-eviction sweep's job).
            sustained = [
                worker_id
                for worker_id, s in self._straggler_state.items()
                if s["flagged"] >= self.STRAGGLER_SUSTAIN_SWEEPS
            ]
        for worker_id, ratio in newly:
            # Outside the lock: recorder event + log for the newly
            # sustained only (not every sweep re-announces).
            tracing.event("worker.straggler", worker=worker_id,
                          job=self._job_id, ratio=round(ratio, 3))
            logger.warning(
                "worker %d flagged as straggler (windowed p50 %.1fx "
                "the cross-worker median)", worker_id, ratio)
        return sustained

    def stragglers(self):
        """Currently sustained straggler ids (no sweep — the view)."""
        with self._lock:
            return [
                worker_id
                for worker_id, s in self._straggler_state.items()
                if s["flagged"] >= self.STRAGGLER_SUSTAIN_SWEEPS
            ]

    def ps_state(self):
        """Copy-safe snapshot of per-shard PS recovery state for the
        status page."""
        with self._lock:
            return {
                ps_id: dict(s)
                for ps_id, s in self.ps_shard_state.items()
            }

    def ps_commit_mark(self):
        """Cross-shard min of the reported durable versions — an UPPER
        BOUND on the committed checkpoint label a restore would come
        back at.  Exact in the common case (every shard saves every
        cadence label); it can overstate when a shard skipped a label
        (``ps_ckpt_failed`` > 0 on any shard is the signal — the true
        committed label may then be older than this mark, the disk is
        authoritative) or before every shard has reported.  None until
        a PS shard has reported.  The gap between ``model_version`` and
        this mark is at least the state a crash right now would lose."""
        with self._lock:
            if not self.ps_shard_state:
                return None
            return min(
                s["durable_version"]
                for s in self.ps_shard_state.values()
            )

    @rpc_error_guard
    def report_version(self, request, _context=None):
        shard_restarted = False
        with self._lock:
            advanced = request.model_version > self._version
            self._version = max(self._version, request.model_version)
            if request.is_ps:
                state = self.ps_shard_state.setdefault(
                    request.ps_id,
                    {"generation": 0, "version": 0,
                     "durable_version": 0},
                )
                # A report from an OLDER incarnation (delayed by its
                # client's outage-riding retry, landing after the
                # relaunch already reported) must not touch the
                # recovery state: its durable_version describes files
                # the restore-time truncation may have deleted, and
                # folding it in would float the commit mark above what
                # is actually on disk.
                if request.generation >= state["generation"]:
                    if state["generation"] and (
                        request.generation > state["generation"]
                    ):
                        shard_restarted = True
                        logger.warning(
                            "PS shard %d serving as generation %d "
                            "(was %d): shard restarted",
                            request.ps_id, request.generation,
                            state["generation"],
                        )
                    state["generation"] = request.generation
                    state["version"] = max(
                        state["version"], request.model_version
                    )
                    # NOT max-folded: a relaunched shard that restored
                    # an older committed version really is durable only
                    # up to there — the mark must move back with it.
                    state["durable_version"] = request.durable_version
        if shard_restarted:
            # In the reporting shard's trace: the restart-generation
            # bump as the master observed it.
            tracing.event("ps.generation_bump", ps_id=request.ps_id,
                          generation=request.generation,
                          durable_version=request.durable_version)
        if advanced and self._journal is not None:
            self._journal.append(
                {"ev": "version", "v": request.model_version}
            )
        if self._evaluation_service is not None:
            self._evaluation_service.add_evaluation_task_if_needed(
                request.model_version
            )
        return pb.Empty()

    @rpc_error_guard
    def report_training_params(self, request, _context=None):
        self.training_params = request
        return pb.Empty()


def create_master_service(servicer, port=0, max_workers=64,
                          interceptors=None):
    """Start an in-process gRPC master service; returns (server, port).

    ``interceptors``: e.g. a grpc_utils.FaultInjectionInterceptor —
    drills script deterministic master outages with --rpc_fault_spec."""
    server = grpc_utils.build_server(
        max_workers=max_workers, interceptors=interceptors
    )
    rpc.add_master_servicer(servicer, server)
    bound = server.add_insecure_port("[::]:%d" % port)
    server.start()
    logger.info("master service listening on port %d", bound)
    return server, bound
