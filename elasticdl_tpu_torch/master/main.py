"""Master entrypoint (parity: elasticdl/python/master/main.py:20-24;
counterpart of ``elasticdl_tpu/master/main.py``).

Builds the control plane from flags, optionally launches/manages workers
(local-process backend), runs the job to completion.  The port runs the
default path: the ``local`` strategy over process workers
(``python -m elasticdl_tpu_torch.worker.main``).  Flag values that select
another path (k8s workers, the collective and PS strategies, the
multi-tenant scheduler, the status server, predict and evaluate jobs)
raise ``NotImplementedError`` naming their ROADMAP item
(``utils.args.check_ported``).  The model spec the master loads to size
its work is the port's, so no process of a port job imports JAX.
"""

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.master.worker_manager import (
    ProcessWorkerBackend,
    WorkerManager,
)
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.args import (
    build_arguments_from_parsed_result,
    check_ported,
    parse_master_args,
)
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_MASTER_ONLY_ARGS = (
    "port", "num_workers", "num_ps", "shuffle", "shuffle_shards",
    "max_task_retries", "task_timeout_secs", "relaunch_on_worker_failure",
    "grads_to_wait", "sync_version_tolerance",
    "worker_backend", "image", "namespace", "worker_resource_request",
    "tpu_topology", "worker_pod_priority", "cluster_spec", "volume",
    "status_port", "journal_dir", "rpc_fault_spec",
    "ps_rpc_fault_spec",
    "jobs_spec", "sched_cadence_secs", "sched_moves_per_tick",
    "sched_worker_stale_secs",
)

# Job-config fields that must match between the journal and a
# restarted master's flags: replaying a journal into a DIFFERENT job
# (other dataset, other task split) would rebuild nonsense queues.
_JOURNAL_META_FIELDS = (
    "job_name", "job_type", "data_origin", "records_per_task",
    "num_epochs", "seed", "shuffle", "shuffle_shards",
)


def _journal_meta(args, records_per_task):
    meta = {
        field: getattr(args, field) for field in _JOURNAL_META_FIELDS
        if field != "records_per_task"
    }
    meta["records_per_task"] = records_per_task
    return meta


def _check_journal_meta(state, meta):
    if state.meta is None:
        logger.warning("journal has no meta record; replaying anyway")
        return
    mismatched = {
        k: (state.meta.get(k), meta[k])
        for k in meta if state.meta.get(k) != meta[k]
    }
    if mismatched:
        raise RuntimeError(
            "journal replay refused: the journaled job does not match "
            "this master's flags (journaled vs current): %r — point "
            "--journal_dir at a fresh directory for a new job"
            % mismatched
        )


def _build_worker_backend(args, worker_args):
    # --worker_backend k8s was refused by check_ported (ROADMAP A19).
    return ProcessWorkerBackend(worker_args=worker_args)


def build_master(args):
    check_ported(args)
    records_per_task = args.batch_size * args.num_minibatches_per_task
    journal_state = None
    if args.journal_dir:
        from elasticdl_tpu_torch.master.journal import replay_journal

        # The recovery trace: journal replay is this incarnation's
        # root recovery span; every later event this master records
        # carries link_trace back to it, so a worker's outage-riding
        # trace and the replay stitch into ONE incident component
        # (docs/observability.md, cpu_master_kill drill gate).
        with tracing.span("master.journal_replay") as replay_span:
            journal_state = replay_journal(args.journal_dir)
            if journal_state is not None:
                tracing.event(
                    "journal.replayed",
                    restarts=journal_state.restarts,
                    rendezvous_id=journal_state.rendezvous_id,
                )
        if journal_state is not None:
            restart = journal_state.restarts + 1
            tracing.configure_identity(
                "master", generation=restart, restart=restart,
                # replay_span is None when tracing is disabled
                link_trace=getattr(replay_span, "trace", None),
            )
    reader = create_data_reader(
        args.data_origin, records_per_shard=records_per_task
    )
    eval_reader = None
    if args.validation_data_origin:
        eval_reader = create_data_reader(
            args.validation_data_origin, records_per_shard=records_per_task
        )
    common = dict(
        records_per_task=records_per_task,
        num_epochs=args.num_epochs,
        shuffle=args.shuffle,
        shuffle_shards=args.shuffle_shards,
        max_task_retries=args.max_task_retries,
        task_timeout_secs=args.task_timeout_secs,
        seed=args.seed,
    )
    # Predict and evaluate jobs were refused by check_ported (ROADMAP
    # A21): a train job, with evaluation tasks when a validation origin
    # is given.
    task_manager = TaskManager(
        training_shards=reader.create_shards(),
        evaluation_shards=(
            eval_reader.create_shards() if eval_reader else None
        ),
        **common,
    )
    journal = None
    if args.journal_dir:
        from elasticdl_tpu_torch.master.journal import JournalWriter

        journal = JournalWriter(args.journal_dir)
    if journal_state is not None:
        # Master crash-restart: the journal is the exact task/progress
        # state — replaying it supersedes the checkpoint-version
        # skip_records approximation below.
        _check_journal_meta(
            journal_state, _journal_meta(args, records_per_task)
        )
        task_manager.restore_from_journal(journal_state)
        journal.append({"ev": "restart"})
        journal.flush()
        task_manager.attach_journal(journal, bootstrap=False)
    else:
        if journal is not None:
            journal.append(
                {"ev": "meta",
                 "job": _journal_meta(args, records_per_task)}
            )
            # Attach BEFORE any checkpoint skip below, so the skip's
            # done/trim events land in the journal too.
            task_manager.attach_journal(journal, bootstrap=True)
        if args.job_type == "train" and args.checkpoint_dir:
            # Resume: the checkpoint version counts optimizer steps;
            # skip the records those steps consumed so epoch 1
            # continues where the previous run stopped.
            from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

            # The dense single-writer saver: its newest complete
            # version is the resumable one (the PS fleet's committed
            # mark, latest_resumable_version, is ROADMAP A8).
            latest = CheckpointSaver(args.checkpoint_dir).latest_version()
            if latest:
                task_manager.skip_records(latest * args.batch_size)
    spec = load_model_spec(args.model_zoo,
                           model_params=args.model_params)
    evaluation_service = None
    if (
        args.evaluation_steps
        and eval_reader is not None
        and spec.eval_metrics_fn is not None
    ):
        evaluation_service = EvaluationService(
            task_manager,
            spec.eval_metrics_fn,
            evaluation_steps=args.evaluation_steps,
        )
    if spec.callbacks:
        # One worker runs on_train_end (model export) after the last
        # training task (reference: deferred train-end task,
        # task_manager.py:35-68 + callbacks.py:23-66).
        task_manager.set_train_end_callback_task()
    # The collective strategy's rendezvous and coordination service
    # (ROADMAP A4) and the PS strategy's PSManager (A8) were refused by
    # check_ported.
    worker_manager = None
    if args.num_workers > 0:
        worker_args = build_arguments_from_parsed_result(
            args, filter_args=_MASTER_ONLY_ARGS
        )
        worker_manager = WorkerManager(
            _build_worker_backend(args, worker_args),
            num_workers=args.num_workers,
            max_relaunch_count=args.relaunch_on_worker_failure,
        )
    interceptors = None
    if args.rpc_fault_spec:
        from elasticdl_tpu_torch.utils.grpc_utils import (
            FaultInjectionInterceptor,
        )

        logger.warning(
            "RPC fault injection armed: %s", args.rpc_fault_spec
        )
        interceptors = [FaultInjectionInterceptor(args.rpc_fault_spec)]
    master = Master(
        task_manager,
        evaluation_service=evaluation_service,
        worker_manager=worker_manager,
        port=args.port,
        journal=journal,
        interceptors=interceptors,
    )
    if journal_state is not None:
        master.servicer.restore_from_journal(journal_state)
    return master


def _arm_master_slo(servicers):
    """Default master SLO: zero sustained stragglers (the acceptance
    objective the straggler detector feeds — a flagged worker IS a
    breach on /alertz and an ``slo.breach`` flight-recorder event),
    plus any operator rules from $ELASTICDL_SLO_SPEC."""
    from elasticdl_tpu_torch.utils import slo as slo_mod

    wd = slo_mod.default_watchdog()
    wd.add_source(
        "straggler_workers",
        lambda: float(sum(len(s.stragglers()) for s in servicers())))
    wd.add_rule("value(straggler_workers) < 1", name="stragglers",
                description="no worker sustained-flagged as a "
                            "straggler (cross-worker step-time skew)")
    wd.arm_from_env()


def main(argv=None):
    args = parse_master_args(argv)
    tracing.configure_identity("master")
    tracing.arm_crash_dump()
    logger.info("master starting: %s", vars(args))
    # build_master refuses --jobs_spec (ROADMAP A20), --status_port (A15)
    # and every other unported path before anything starts.
    master = build_master(args)
    master.prepare()
    _arm_master_slo(lambda: [master.servicer])
    try:
        return master.run()
    finally:
        if master.journal is not None:
            master.journal.close()


if __name__ == "__main__":
    raise SystemExit(main())
