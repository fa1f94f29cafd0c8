"""Worker task loop.

Parity with elasticdl/python/worker/worker.py:46-449: fetch task -> stream
records -> train/evaluate/predict minibatches; a failing minibatch retries
up to 64 times (reference DEFAULT_MAX_MINIBATCH_RETRY_NUM, worker.py:39);
evaluation results go to the master's evaluation service; the train-end
callback task runs model-export callbacks on exactly one worker.
"""

import os
import time

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import hist as hist_mod
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.retry import RetryPolicy
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.data_shard_service import DataShardService
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = get_logger(__name__)

DEFAULT_MAX_MINIBATCH_RETRY_NUM = 64

# Container convention for "terminated by SIGTERM" — the worker manager
# classifies it as a preemption (relaunch), not a failure.
PREEMPTED_EXIT_CODE = 143


class PreemptedExit(Exception):
    """Raised inside the task loop when a graceful-preemption stop was
    requested (SIGTERM): unwind cleanly after the current minibatch."""


# Drill knob: "id:ms[,id:ms...]" — a deliberate per-step sleep for the
# NAMED worker ids only (bench_elastic's straggler leg throttles one
# member of a managed pool through the shared environment).
ENV_STEP_THROTTLE = "ELASTICDL_STEP_THROTTLE_SPEC"


def step_throttle_secs(worker_id, spec=None):
    """Seconds of deliberate per-step sleep for ``worker_id`` under
    the current ELASTICDL_STEP_THROTTLE_SPEC ("id:ms,..."), else 0.
    Malformed specs are ignored loudly — a drill typo must never
    change training behavior silently."""
    spec = (os.environ.get(ENV_STEP_THROTTLE, "")
            if spec is None else spec)
    for piece in spec.split(","):
        piece = piece.strip()
        if not piece:
            continue
        try:
            wid, ms = piece.split(":")
            if int(wid) == worker_id:
                throttle = float(ms) / 1e3
                logger.warning(
                    "worker %d DELIBERATELY throttled %.0f ms/step "
                    "(%s)", worker_id, float(ms), ENV_STEP_THROTTLE)
                return throttle
        except ValueError:
            logger.warning("ignoring bad %s piece %r",
                           ENV_STEP_THROTTLE, piece)
    return 0.0


class Worker:
    def __init__(
        self,
        master_client,
        data_reader,
        spec,
        trainer,
        batch_size,
        max_minibatch_retries=DEFAULT_MAX_MINIBATCH_RETRY_NUM,
        log_loss_steps=100,
        join_rendezvous=False,
        elastic_controller=None,
        fused_steps=1,
        device_prefetch=2,
        job_context_factory=None,
        initial_job_config=None,
    ):
        """``elastic_controller`` (ElasticCollectiveController): drives
        the multi-controller collective world from inside the managed
        task loop — epoch checks before minibatches (step-count
        cadence, SPMD-aligned across workers) and await-new-epoch on a
        failed collective.  None = single-process trainer (the
        historical managed path).

        ``fused_steps``: run up to K optimizer steps per device
        dispatch through the fused-step driver (worker/fused_driver.py)
        when the trainer supports windows; 1 (default) is exactly the
        classic per-step loop.  ``device_prefetch``: prepared-batch
        lookahead depth for the producer stage; > 0 also stages the
        next window's device transfer behind the running step, 0 keeps
        batch prep on the dispatch path.

        ``job_context_factory`` (multi-tenant pools, docs/scheduler.md):
        ``factory(job_config) -> (data_reader, spec, trainer)`` —
        called when the scheduler re-assigns this worker to a
        different job (the get_task handshake), so the worker rebuilds
        its data pipeline and per-job model state IN PLACE, without a
        process restart.  None = single-job worker (handshakes are
        adopted as an id only)."""
        self._mc = master_client
        self._spec = spec
        self._trainer = trainer
        self._batch_size = batch_size
        self._max_minibatch_retries = max_minibatch_retries
        self._log_loss_steps = log_loss_steps
        self._join_rendezvous = join_rendezvous
        self._elastic = elastic_controller
        self._fused_steps = max(1, int(fused_steps))
        self._device_prefetch = max(0, int(device_prefetch))
        self._shard_service = DataShardService(
            master_client, batch_size,
            # The WAIT poll must abort on graceful preemption — an idle
            # worker's grace window would otherwise expire inside it.
            stop_check=lambda: self._preempt_requested,
            # Live steps/s + health piggybacked on every progress RPC
            # (docs/observability.md): the master aggregates these into
            # its per-job telemetry surface.
            telemetry_fn=self._telemetry_snapshot,
        )
        self._data_service = TaskDataService(data_reader, spec.feed)
        self.timing = Timing(logger=logger)
        # One retry policy family (utils/retry.py): the minibatch loop
        # below keeps its structure (the elastic branch re-rendezvouses
        # instead of sleeping) but the backoff/budget bookkeeping and
        # the rpc_retry/rpc_gaveup counters are shared with every other
        # outage-riding client in the worker.
        self._minibatch_backoff = RetryPolicy(
            name="minibatch",
            max_attempts=max_minibatch_retries,
            deadline_secs=None,
            base_delay_secs=0.1,
            max_delay_secs=3.0,
            timing=self.timing,
        )
        retry_policy = getattr(master_client, "retry_policy", None)
        if retry_policy is not None and retry_policy.timing is None:
            # The MasterClient is built before the Worker owns a
            # Timing; bind it so master-RPC retries land in the same
            # reported counters.
            retry_policy.timing = self.timing
        self._steps = 0
        self._preempt_requested = False
        self.preempted = False
        # Multi-tenant re-assignment handshake state: the job this
        # worker's pipeline is currently built for, and the config key
        # it was built from (an identical config skips the rebuild —
        # e.g. the pool template already matches the assigned job).
        self._job_factory = job_context_factory
        self._job_id = getattr(master_client, "job_id", 0) or 0
        self._job_key = (
            self._job_config_key(initial_job_config)
            if initial_job_config else None
        )
        # Drill-only deliberate slowdown (straggler staging): the
        # ELASTICDL_STEP_THROTTLE_SPEC env names worker ids — every
        # pool worker inherits the same env, each applies only its
        # own entry, so a drill can throttle ONE member of a managed
        # pool without per-worker plumbing.
        self._step_throttle = step_throttle_secs(
            getattr(master_client, "worker_id", -1))
        # (monotonic mark, steps at mark) for the steps/s telemetry
        # interval; written and read only on the training thread (the
        # progress-RPC flush runs there).
        self._tele_mark = (None, 0)
        # Step-time histogram snapshot at the previous report — the
        # piggybacked delta is cur - prev, so the master's merge stays
        # an exact cumulative sum however reports interleave.  Same
        # single-thread discipline as _tele_mark.
        self._tele_hist_prev = None

    def _telemetry_snapshot(self):
        """Telemetry dict for the next progress RPC: worker-local
        steps/s over the interval since the previous report,
        blocked-on-device fraction, PS push-pipeline depth, the mean
        fused-window size, and the sparse step-time histogram delta
        (docs/observability.md — the master's per-job p50/p99 and the
        straggler detector derive from it)."""
        now = time.monotonic()
        mark_t, mark_steps = self._tele_mark
        self._tele_mark = (now, self._steps)
        out = {"steps_done": self._steps}
        step_snap = self.timing.hist_snapshot("step_time")
        if step_snap is not None:
            d = hist_mod.delta(step_snap, self._tele_hist_prev)
            self._tele_hist_prev = step_snap
            if d["count"]:
                out["hist_delta"] = hist_mod.encode_deltas(
                    {"step_time": d})
        if mark_t is not None and now > mark_t and (
            self._steps > mark_steps
        ):
            out["steps_per_sec"] = (
                (self._steps - mark_steps) / (now - mark_t)
            )
        staleness = getattr(self._trainer, "push_staleness", None)
        if staleness is not None:
            out["push_staleness"] = float(staleness())
        counters = self.timing.counters()
        windows = counters.get("fused_windows", 0)
        if windows:
            out["window_size"] = (
                counters.get("fused_steps_run", 0) / windows
            )
            # Only meaningful on the fused path: the per-step loop
            # records loss_sync but never window_dispatch, so the
            # ratio there would read 1.0 ("fully device-stalled") on
            # every default-config worker regardless of overlap.
            sync = self.timing.sync_fraction("window_dispatch",
                                             "loss_sync")
            if sync is not None:
                out["sync_fraction"] = sync
        return out

    # Handshake-config fields that change what the worker pipeline is
    # built from.  Used ONLY for the first-assignment fast path (pool
    # template already matches the job): cross-job moves always
    # rebuild, identical config or not — tenant isolation.
    _JOB_KEY_FIELDS = (
        "model_zoo", "model_params", "data_origin", "batch_size",
        "num_minibatches_per_task", "seed", "checkpoint_dir",
        "distribution_strategy",
    )

    @classmethod
    def _job_config_key(cls, cfg):
        return tuple(
            (field, cfg.get(field)) for field in cls._JOB_KEY_FIELDS
        )

    def _maybe_switch_job(self):
        """The re-assignment handshake (docs/scheduler.md): when the
        master's get_task response moved this worker to a different
        job, rebuild the data pipeline / per-job trainer state IN
        PLACE — the process survives, which is the whole point of the
        shared pool.  A pipeline-identical config (the pool template
        matching the assigned job) skips the rebuild."""
        new_job = getattr(self._mc, "job_id", 0) or 0
        if not new_job or new_job == self._job_id:
            return
        prev_job, self._job_id = self._job_id, new_job
        cfg = getattr(self._mc, "job_config", None)
        if self._job_factory is None or not cfg:
            logger.info(
                "adopted job %d (no context factory; pipeline kept)",
                new_job,
            )
            return
        key = self._job_config_key(cfg)
        if prev_job == 0 and key == self._job_key:
            # Fast path for the FIRST assignment only: the eagerly
            # built pool-template pipeline already matches this job,
            # and no other tenant's state has touched it.  A CROSS-JOB
            # move always rebuilds even on an identical config —
            # reusing the trainer would carry the previous tenant's
            # trained parameters into the new job.
            logger.info(
                "registered into job %s (id %d): pool template "
                "matches, rebuild skipped", cfg.get("job"), new_job,
            )
            return
        # Note: collective pool workers never reach here — their
        # elastic controller is bound to ONE trainer, so worker/main
        # wires the factory for local-strategy pools only and
        # collective workers adopt re-assignments as an id (the
        # factory-None path above).  Cross-job collective moves would
        # add LOOP_END(old job)/leave_world before the rebuild and
        # LOOP_START/rejoin_world after it.
        with tracing.span("worker.job_switch", job=new_job,
                          prev_job=prev_job,
                          job_name=str(cfg.get("job"))):
            old_trainer = self._trainer
            if old_trainer is not None and hasattr(old_trainer,
                                                  "close"):
                try:
                    old_trainer.close()
                except Exception as e:  # noqa: BLE001 — best effort:
                    # the old job's trainer must not block the new one
                    logger.warning("old trainer close failed: %s", e)
            reader, spec, trainer = self._job_factory(cfg)
            self._spec = spec
            self._trainer = trainer
            self._data_service = TaskDataService(reader, spec.feed)
            batch_size = int(cfg.get("batch_size") or self._batch_size)
            self._batch_size = batch_size
            self._shard_service.set_batch_size(batch_size)
            self._job_key = key
        logger.info(
            "switched to job %s (id %d): data=%s model=%s",
            cfg.get("job"), new_job, cfg.get("data_origin"),
            cfg.get("model_zoo"),
        )

    def request_stop(self):
        """Graceful-preemption hook (SIGTERM handler, worker main):
        finish the in-flight minibatch, checkpoint if configured,
        report the unfinished task back, exit with PREEMPTED_EXIT_CODE
        so the manager relaunches.  Preemptible TPU VMs give ~30 s of
        notice — enough to save the optimizer trajectory instead of
        replaying from the last periodic checkpoint (reference analog:
        pod eviction grace)."""
        self._preempt_requested = True

    # -- task handlers ------------------------------------------------------

    def _process_minibatch(self, features, labels):
        err = None
        for callback in self._spec.callbacks:
            if hasattr(callback, "on_train_batch_begin"):
                callback.on_train_batch_begin(self._trainer)
        for attempt in range(self._max_minibatch_retries):
            try:
                if self._elastic is not None:
                    # Step-count cadence: every member of the world
                    # checks at the same collective index, so nobody
                    # leaves an epoch while a peer is blocked inside
                    # one of its collectives.
                    self._elastic.step_check()
                loss, version = self._trainer.train_minibatch(
                    features, labels
                )
                if (
                    self._elastic is not None
                    and self._elastic.world_size > 1
                ):
                    # Multi-controller worlds keep the per-step sync:
                    # an in-band collective failure must surface ON the
                    # failing minibatch, inside THIS retry scope, so
                    # the await-new-epoch recovery below retries the
                    # right batch before its records are reported done.
                    # (Cross-process collectives serialize on the wire
                    # anyway — the lazy-loss win lives on the
                    # single-controller hot paths.)
                    float(loss)
                self._steps += 1
                if self._steps % self._log_loss_steps == 0:
                    # train_minibatch returns a LAZY device loss; this
                    # float() is the only per-cadence host sync.
                    with self.timing.timeit("loss_sync"):
                        loss_value = float(loss)
                    logger.info(
                        "step %d loss %.6f (version %d)",
                        self._steps, loss_value, version,
                    )
                if self._step_throttle:
                    # Drill knob (step_throttle_secs): a DELIBERATE
                    # per-step slowdown so churn drills can stage a
                    # straggler and gate the detector on it.
                    time.sleep(self._step_throttle)
                return loss
            except Exception as e:  # noqa: BLE001 — retry then surface
                err = e
                logger.warning(
                    "minibatch failed (attempt %d): %s", attempt + 1, e
                )
                if (
                    self._elastic is not None
                    and self._elastic.world_size > 1
                ):
                    # In-band collective failure: the world is dead
                    # until the master commits a new epoch (reference
                    # allreduce_trainer.py:77-91) — wait for it; if
                    # none arrives (transient error, membership
                    # unchanged) force a re-init of the current world.
                    # Each of these costs up to a minute, so the
                    # elastic path gets a SHORT retry budget — after
                    # that the task fails and the task-retry machinery
                    # takes over.
                    if attempt + 1 >= 3:
                        break
                    if not self._elastic.await_new_epoch():
                        self._elastic.init_world_if_needed(force=True)
                    continue
                # Jittered exponential backoff (shared policy) so the
                # retry budget rides out transient outages (a PS shard
                # relaunching takes seconds; 64 instant retries would
                # burn out in <1s).
                self._minibatch_backoff.pause(min(attempt, 5))
        raise RuntimeError(
            "minibatch failed after %d retries" % self._max_minibatch_retries
        ) from err

    def _windowed_driver(self):
        """The fused-step driver when it would actually fuse (> 1 step
        per dispatch); None selects the classic per-step loop — which
        stays the path for ``--fused_steps 1``, the PS trainer
        (max_window 1) and multi-controller collectives."""
        if self._fused_steps <= 1 or not hasattr(
            self._trainer, "train_window"
        ):
            return None
        from elasticdl_tpu_torch.worker.fused_driver import FusedStepDriver

        driver = FusedStepDriver(
            self._trainer, self._shard_service, self.timing,
            fused_steps=self._fused_steps,
            device_prefetch=self._device_prefetch,
            log_loss_steps=self._log_loss_steps,
            elastic=self._elastic,
            stop_check=lambda: self._preempt_requested,
            callbacks=self._spec.callbacks,
            step_throttle_secs=self._step_throttle,
            # Prep placement: producer thread when no elastic
            # controller (overlap), inside the driver AFTER the epoch
            # check otherwise — a world re-form can change batch
            # geometry (accum resize), and batches prepared ahead
            # under the old world must never be dispatched after it.
            prepare=(
                None if self._producer_prepares()
                else lambda item: self._trainer.prepare_batch(*item)
            ),
        )
        return driver if driver.effective_window > 1 else None

    def _producer_prepares(self):
        return self._device_prefetch > 0 and self._elastic is None

    def _run_task_windowed(self, task, driver):
        """Fused hot loop: batch prep in the prefetch producer, K steps
        per dispatch, device double-buffer, coalesced progress RPCs,
        loss fetched at cadence (docs/training_pipeline.md)."""
        from elasticdl_tpu_torch.data.parallel_reader import prefetch_batches

        prepare = None
        if self._producer_prepares():
            prepare = lambda item: self._trainer.prepare_batch(*item)
        # else: the driver preps each window itself, after its elastic
        # epoch check (or at dispatch with --device_prefetch 0) — the
        # stream hands raw (features, labels, count) items through.
        batches = prefetch_batches(
            self._data_service.batch_stream(task, self._batch_size),
            depth=max(2, self._device_prefetch),
            prepare=prepare,
        )
        ran, preempted = driver.run_task(
            batches, steps_done=self._steps
        )
        self._steps += ran
        if preempted or self._preempt_requested:
            raise PreemptedExit()

    def _train_task(self, task):
        from elasticdl_tpu_torch.data.parallel_reader import prefetch_batches

        driver = self._windowed_driver()
        # PS trainers can start the NEXT batch's embedding pulls while
        # the current device step runs; the one-batch lookahead below
        # feeds that prefetcher (it composes with prefetch_batches,
        # which overlaps read/decode/feed one stage earlier).
        prefetch_embeddings = getattr(
            self._trainer, "prefetch_embeddings", None
        )
        with self.timing.timeit("task_process"):
            try:
                if driver is not None:
                    self._run_task_windowed(task, driver)
                    return
                # Prefetch so host-side read/decode/feed overlaps the
                # device step (the input-pipeline half of keeping the
                # MXU busy); producer errors re-raise here where the
                # task-failure reporting lives.
                batches = prefetch_batches(
                    self._data_service.batch_stream(
                        task, self._batch_size
                    ),
                    depth=2,
                )
                pending = next(batches, None)
                t_prev = time.perf_counter()
                while pending is not None:
                    features, labels, count = pending
                    pending = next(batches, None)
                    if pending is not None and prefetch_embeddings:
                        prefetch_embeddings(pending[0])
                    loss = self._process_minibatch(features, labels)
                    # Per-step wall time into the step-time histogram
                    # (the fused path observes per window); feeds the
                    # master's per-job p50/p99 via the telemetry
                    # piggyback's hist delta.
                    t_now = time.perf_counter()
                    self.timing.observe("step_time", t_now - t_prev)
                    t_prev = t_now
                    if pending is None:
                        # Task-final fence: the last report below can
                        # auto-complete the task at the master, so the
                        # last (lazy) step must verifiably finish
                        # first — the completion guarantee the loop
                        # used to get for free from per-step
                        # float(loss); steps chain through params, so
                        # fencing the last one proves them all.
                        with self.timing.timeit("loss_sync"):
                            float(loss)
                    self._shard_service.report_batch_done(count)
                    if self._preempt_requested:
                        raise PreemptedExit()
            except PreemptedExit:
                # Give the unfinished remainder back WITHOUT consuming
                # a retry (the task isn't at fault — frequent evictions
                # must not permanently fail it), and unwind to run(),
                # which checkpoints and exits.
                self._shard_service.report_task_failed(
                    task, "worker preempted (graceful)", requeue=True)
                raise
            except Exception as e:  # noqa: BLE001
                # Report the failure so the master can retry the task on
                # another worker; keep this worker alive for the next task.
                logger.error("training task %d failed: %s", task.id, e)
                self._shard_service.report_task_failed(task, str(e))

    def _evaluate_task(self, task):
        try:
            for features, labels, _ in self._data_service.batch_stream(
                task, self._batch_size
            ):
                outputs, labels = self._trainer.evaluate_minibatch(
                    features, labels
                )
                self._mc.report_evaluation_metrics(
                    outputs, labels, model_version=task.model_version,
                )
            self._shard_service.report_task_done(task)
        except Exception as e:  # noqa: BLE001
            self._shard_service.report_task_failed(task, str(e))
            raise

    def _predict_task(self, task):
        processor = self._spec.prediction_outputs_processor
        try:
            for features, _labels, _ in self._data_service.batch_stream(
                task, self._batch_size
            ):
                outputs = self._trainer.predict_minibatch(features)
                if processor is not None:
                    processor.process(outputs, self._mc.worker_id)
            if processor is not None and hasattr(processor, "flush"):
                processor.flush()
            self._shard_service.report_task_done(task)
        except Exception as e:  # noqa: BLE001
            self._shard_service.report_task_failed(task, str(e))
            raise

    def _train_end_task(self, task):
        try:
            # Join any in-flight async checkpoint write before export
            # callbacks read the checkpoint directory.
            if hasattr(self._trainer, "flush_checkpoints"):
                self._trainer.flush_checkpoints()
            for callback in self._spec.callbacks:
                if hasattr(callback, "on_train_end"):
                    callback.on_train_end(self._trainer)
            self._shard_service.report_task_done(task)
        except Exception as e:  # noqa: BLE001
            self._shard_service.report_task_failed(task, str(e))
            raise

    # -- main loop ----------------------------------------------------------

    def _fetch_task_elastic(self):
        """Fetch without idling INSIDE the collective world.

        A worker holding no task must not stall its peers' collectives
        (they step in lockstep) nor keep a heartbeat against an epoch
        service the master will reap — so on WAIT it LEAVES the world
        (LOOP_END + drop the coordination client; the survivors
        re-form without it), polls for work from outside, and rejoins
        (LOOP_START + re-init) when a task shows up."""
        from elasticdl_tpu_torch.worker.data_shard_service import WAIT

        task = self._shard_service.fetch_task(return_wait=True)
        if task is not WAIT:
            return task
        logger.info("no task available; leaving the collective world")
        self._elastic.leave_world()
        self._mc.report_train_loop_status(pb.LOOP_END)
        while task is WAIT:
            if self._preempt_requested:
                raise PreemptedExit()  # honor SIGTERM while idle too
            time.sleep(0.5)
            task = self._shard_service.fetch_task(return_wait=True)
        if task is not None:
            logger.info("task available; rejoining the collective world")
            self._mc.report_train_loop_status(pb.LOOP_START)
            self._elastic.rejoin_world()
        return task

    def _run_one_task(self, task):
        # One span per task: everything underneath — minibatch RPC
        # client spans, outage-riding retry events, the master-side
        # server spans and task.completed breadcrumbs — shares this
        # trace, so a churn drill reads as one causal timeline.
        with tracing.span("worker.task", task=task.id,
                          type=int(task.type)):
            if task.type == pb.TRAINING:
                self._train_task(task)
            elif task.type == pb.EVALUATION:
                self._evaluate_task(task)
            elif task.type == pb.PREDICTION:
                self._predict_task(task)
            elif task.type == pb.TRAIN_END_CALLBACK:
                self._train_end_task(task)
            else:
                logger.warning("unknown task type %s", task.type)
                self._shard_service.report_task_done(task)

    def run(self):
        # Root span for the whole run: the worker's single trace id —
        # task spans nest under it, so even fetch-loop retries during
        # a master outage land in the same trace.
        with tracing.span("worker.run", worker=self._mc.worker_id):
            self._run_traced()

    def _run_traced(self):
        if self._join_rendezvous:
            self._mc.report_train_loop_status(pb.LOOP_START)
        try:
            while True:
                if self._preempt_requested:
                    raise PreemptedExit()
                if self._elastic is not None:
                    task = self._fetch_task_elastic()
                else:
                    task = self._shard_service.fetch_task()
                # The get_task that delivered this task may have been
                # the scheduler's re-assignment handshake: rebuild the
                # pipeline for the new job BEFORE processing the task.
                self._maybe_switch_job()
                if task is None:
                    if self._preempt_requested:
                        # The fetch aborted because of the SIGTERM, not
                        # because the job finished — checkpoint first.
                        raise PreemptedExit()
                    break
                self._run_one_task(task)
        except PreemptedExit:
            self.preempted = True
            logger.warning(
                "graceful preemption: saving checkpoint and exiting")
            if getattr(self._trainer, "_checkpoint_saver", None):
                try:
                    self._trainer.save_checkpoint()
                    self._trainer.flush_checkpoints()
                except Exception as e:  # noqa: BLE001 — best effort
                    # under a kill deadline: a failed save must not
                    # mask the preemption exit path
                    logger.error("preemption checkpoint failed: %s", e)
        finally:
            if hasattr(self._trainer, "close"):
                # Drain any in-flight async gradient pushes and stop
                # the trainer's background threads before reporting.
                try:
                    self._trainer.close()
                except Exception as e:  # noqa: BLE001 — best effort
                    logger.warning("trainer close failed: %s", e)
            if self._join_rendezvous:
                self._mc.report_train_loop_status(pb.LOOP_END)
            self.timing.report()
