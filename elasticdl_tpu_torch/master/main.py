"""Master entrypoint (parity: elasticdl/python/master/main.py:20-24;
counterpart of ``elasticdl_tpu/master/main.py``).

Builds the control plane from flags, optionally launches/manages workers,
runs the job to completion.  The port runs the ``local``, ``collective``
and ``ps`` strategies over process workers
(``python -m elasticdl_tpu_torch.worker.main``) or, under
``--worker_backend k8s``, over worker pods (``master/k8s_backend.py``):
the master then binds ``client/k8s_submit.MASTER_PORT``, the port its
Service maps, and advertises the Service's DNS name.  For
``collective`` the master also hosts the rendezvous and one
``torch.distributed`` store per membership epoch
(``parallel/distributed.py``), on ``localhost`` for process workers and
on the pod's ``POD_IP`` on k8s; for ``ps`` it launches, watches and
relaunches ``--num_ps`` parameter-server shards
(``master/ps_manager.py``, ``python -m elasticdl_tpu_torch.ps.server``)
and hands their addresses to the workers.  ``--job_type`` ``train``,
``predict`` and ``evaluate`` run as in the JAX package, and
``--status_port`` serves ``/healthz``, ``/status``, ``/metrics``,
``/tracez``, ``/alertz`` and ``/profilez`` (``master/status_server.py``).
``--jobs_spec`` runs the multi-tenant control plane instead
(``master/scheduler.py``): J train jobs over one pool of workers that
the resize controller moves between them without restarts.  The model
spec the master loads to size its work is the port's, so no process of
a port job imports JAX.  The master launches its workers before it
builds its data readers and loads that spec (both import torch), on a
port it holds reserved, so their start-ups overlap; they wait for its
service.  That order, and under ``--jobs_spec`` the check that each
job's ``model_zoo`` names a module before the pool starts, is where it
differs from the reference, besides the package (ROADMAP Queue C,
documented differences).
"""

import importlib.util
import os
import socket

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.master.worker_manager import (
    ProcessWorkerBackend,
    WorkerManager,
)
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
    if args.worker_backend == "k8s":
        from elasticdl_tpu_torch.client.k8s_renderer import (
            parse_resource_string,
        )
        from elasticdl_tpu_torch.master.k8s_backend import (
            K8sWorkerBackend,
            owner_ref_from_env,
        )

        return K8sWorkerBackend(
            job_name=args.job_name,
            image=args.image,
            namespace=args.namespace,
            worker_args=worker_args,
            resources=parse_resource_string(args.worker_resource_request),
            tpu_topology=args.tpu_topology or None,
            num_workers=args.num_workers,
            high_priority_fraction=args.worker_pod_priority,
            cluster_spec=args.cluster_spec,
            owner_ref=owner_ref_from_env(),
            volume=args.volume,
        )
    return ProcessWorkerBackend(worker_args=worker_args)


def _master_port(args):
    """``--port``; on k8s, where it is unset, the port the master's
    Service maps (``client/k8s_submit.MASTER_PORT``): pods dial the
    Service, whose targetPort is fixed, so a free-port bind would be
    unreachable.  0 = a free port, reserved by the caller."""
    if args.worker_backend == "k8s" and not args.port:
        from elasticdl_tpu_torch.client.k8s_submit import MASTER_PORT

        return MASTER_PORT
    return args.port


def _advertise_addr(args):
    """How managed workers dial the master (``%d`` = its port): the
    Service's DNS name on k8s (the Service the submission created),
    localhost for process workers."""
    if args.worker_backend == "k8s":
        return "%s-master.%s.svc:%%d" % (args.job_name, args.namespace)
    return "localhost:%d"


def _coordination_host(args):
    """Where collective workers dial the per-epoch stores.  Those bind
    fresh ports the master's k8s Service does not map, so pods dial the
    master pod itself: ``POD_IP`` (downward API, injected by
    ``client/k8s_submit.py``), and fail fast when it is missing — a
    Service-DNS fallback would only produce opaque worker-side connect
    timeouts.  Process workers dial localhost."""
    if args.worker_backend != "k8s":
        return "localhost"
    host = os.environ.get("POD_IP")
    if not host:
        raise RuntimeError(
            "collective strategy on k8s requires the POD_IP downward-API "
            "env (the per-epoch coordination ports are not mapped by the "
            "master Service); resubmit with a current client — "
            "client/k8s_submit.py injects it")
    return host


def _reserve_port():
    """A free port, held by a bound socket that does not listen
    (``SO_REUSEPORT``, which gRPC's server sets too) until the master's
    gRPC server has bound it: workers launched before the master serves
    dial it, and no other process can take it meanwhile.  Returns (port,
    socket); close the socket once the server is up."""
    sock = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind(("::", 0))
    return sock.getsockname()[1], sock


def _check_zoo_module(name):
    """Fail before any worker starts when ``--model_zoo`` names no
    module (found without importing it: importing a zoo module imports
    torch)."""
    module = name if "." in name else "elasticdl_tpu_torch.models." + name
    if importlib.util.find_spec(module) is None:
        raise ModuleNotFoundError("No module named %r" % module,
                                  name=module)


def _build_worker_manager(args, ps_manager=None):
    worker_args = build_arguments_from_parsed_result(
        args, filter_args=_MASTER_ONLY_ARGS
    )
    if ps_manager is not None:
        worker_args += ["--ps_addrs", ps_manager.addrs]
    return WorkerManager(
        _build_worker_backend(args, worker_args),
        num_workers=args.num_workers,
        max_relaunch_count=args.relaunch_on_worker_failure,
    )


def _launch_workers_early(args, ps_manager=None):
    """The workers, launched before the master imports torch: (worker
    manager, port, reservation).  The port is ``_master_port``'s, or a
    free one held by ``reservation`` (close it once the gRPC server is
    up); the workers wait for the master's service there."""
    port, reservation = _master_port(args), None
    if not port:
        port, reservation = _reserve_port()
    worker_manager = _build_worker_manager(args, ps_manager)
    worker_manager.set_master_addr(_advertise_addr(args).replace(
        "%d", str(port)))
    try:
        worker_manager.start()
    except BaseException:
        if reservation is not None:
            reservation.close()
        raise
    return worker_manager, port, reservation


def build_master(args):
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
    # The master's data and model spec import torch (seconds), and the
    # workers need neither: they start first, so their own start-up
    # overlaps it, and wait for the master's service, which serves only
    # once the master is whole (prepare()).  Under the PS strategy they
    # are given the shards' addresses now; the shards, which need the
    # spec's optimizer, start after prepare() (main).
    coord_host = (_coordination_host(args)
                  if args.distribution_strategy == "collective" else None)
    worker_manager = ps_manager = reservation = None
    port = _master_port(args)
    if args.distribution_strategy == "ps" and args.num_ps > 0:
        from elasticdl_tpu_torch.master.ps_manager import PSManager

        # The optimizer comes from the spec, once it is loaded.
        ps_manager = PSManager(
            args.num_ps, None, None,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_steps=args.checkpoint_steps,
            evaluation_steps=args.evaluation_steps,
            use_async=args.use_async,
            grads_to_wait=args.grads_to_wait,
            sync_version_tolerance=args.sync_version_tolerance,
            # Worker->PS drills: each shard arms this as its own
            # --rpc_fault_spec.
            ps_fault_spec=args.ps_rpc_fault_spec,
        )
    if args.num_workers > 0:
        _check_zoo_module(args.model_zoo)
        worker_manager, port, reservation = _launch_workers_early(
            args, ps_manager)
    try:
        master = _build_master(args, records_per_task, journal_state,
                               worker_manager, port, coord_host)
    except BaseException:
        # Workers launched early must not outlive a master that failed
        # to come up (they would wait for its service).
        if worker_manager is not None:
            worker_manager.stop()
        if reservation is not None:
            reservation.close()
        raise
    master.ps_manager = ps_manager
    master.port_reservation = reservation
    # prepare() points the manager (and every relaunch) at this address.
    master.advertise_addr = _advertise_addr(args)
    if ps_manager is not None:
        ps_manager._opt_type, ps_manager._opt_args = (
            master.model_spec.ps_optimizer)
    return master


def _build_master(args, records_per_task, journal_state, worker_manager,
                  port, coord_host):
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
    if args.job_type == "predict":
        task_manager = TaskManager(
            prediction_shards=reader.create_shards(), **common
        )
    elif args.job_type == "evaluate":
        task_manager = TaskManager(
            evaluation_shards=reader.create_shards(), **common
        )
    else:
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

            # The newest committed label: the one a PS fleet restores
            # (one consistent version for every shard), and the dense
            # saver's newest complete version.
            latest = CheckpointSaver(
                args.checkpoint_dir
            ).latest_resumable_version(max(args.num_ps, 1))
            if latest:
                task_manager.skip_records(latest * args.batch_size)
    from elasticdl_tpu_torch.models.spec import load_model_spec

    spec = load_model_spec(args.model_zoo,
                           model_params=args.model_params)
    evaluation_service = None
    if args.job_type == "evaluate":
        if spec.eval_metrics_fn is None:
            raise ValueError(
                "evaluate job requires eval_metrics_fn in the model spec"
            )
        evaluation_service = EvaluationService(
            task_manager, spec.eval_metrics_fn, evaluation_steps=1
        )
        evaluation_service.add_evaluation_task_if_needed(0)
    elif (
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
    rendezvous = None
    if args.distribution_strategy == "collective":
        from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
        from elasticdl_tpu_torch.parallel.distributed import (
            MasterCoordinationService,
            derive_reap_secs,
        )

        # The master hosts each epoch's rendezvous store, so worker
        # churn never strands the survivors (``_coordination_host``).
        rendezvous = RendezvousServer(
            coordinator_factory=MasterCoordinationService(
                host=coord_host,
                # Old-epoch stores outlive the workers' epoch discovery:
                # workers poll every num_minibatches_per_task steps
                # (worker/main.py passes the same value as check_steps).
                reap_secs=derive_reap_secs(
                    check_steps=max(1, args.num_minibatches_per_task)),
            ).start_epoch,
            journal=journal,
            # Restart re-arms STRICTLY past every epoch a worker can
            # hold (journaled id, +1 for an un-journaled commit racing
            # the crash) so reconnecting workers re-form at a fresh id.
            initial_epoch=(
                journal_state.rendezvous_id + 1 if journal_state else 0),
            # The job's first world is the one it launched.
            initial_world=args.num_workers,
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
        rendezvous_server=rendezvous,
        evaluation_service=evaluation_service,
        worker_manager=worker_manager,
        port=port,
        journal=journal,
        interceptors=interceptors,
    )
    if journal_state is not None:
        master.servicer.restore_from_journal(journal_state)
    master.model_spec = spec
    return master


def _load_jobs_spec(text):
    """--jobs_spec accepts inline JSON or a path to a JSON file; the
    value is a list of job-spec dicts (docs/scheduler.md)."""
    import json

    if os.path.exists(text):
        with open(text) as fh:
            text = fh.read()
    spec = json.loads(text)
    if not isinstance(spec, list) or not spec:
        raise ValueError(
            "--jobs_spec must be a non-empty JSON list of job specs"
        )
    return spec


def build_multitenant_master(args):
    """The multi-tenant control plane (master/scheduler.py): J jobs,
    each with its own task queue, rendezvous epoch space, journal
    namespace and telemetry aggregate, over ONE shared worker pool
    driven by the resize controller.  Train-type local/collective jobs
    only — a PS-mode job keeps its own single-job master.  As in the
    single-job master, the pool launches before the jobs' data readers
    are built (they import torch), once every spec's ``model_zoo`` and
    the pool template's are known to name a module."""
    from elasticdl_tpu_torch.master.scheduler import JobSpec

    specs = [
        JobSpec.from_dict(entry, defaults=args)
        for entry in _load_jobs_spec(args.jobs_spec)
    ]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError("duplicate job names in --jobs_spec: %s"
                         % names)
    worker_manager = reservation = None
    port = _master_port(args)
    if args.num_workers > 0:
        # A managed pool never grows past --num_workers, so a job
        # whose floor exceeds it could NEVER be admitted — the run
        # would hang forever in the admission queue.  Fail fast.
        impossible = [
            s.name for s in specs if s.min_workers > args.num_workers
        ]
        if impossible:
            raise ValueError(
                "jobs %s require min_workers > --num_workers (%d) "
                "and could never be admitted" % (impossible,
                                                 args.num_workers)
            )
        for model_zoo in [args.model_zoo] + [s.model_zoo for s in specs]:
            _check_zoo_module(model_zoo)
        worker_manager, port, reservation = _launch_workers_early(args)
    try:
        master = _build_multitenant_master(args, specs, worker_manager,
                                           port)
    except BaseException:
        if worker_manager is not None:
            worker_manager.stop()
        if reservation is not None:
            reservation.close()
        raise
    master.port_reservation = reservation
    return master


def _build_multitenant_master(args, specs, worker_manager, port):
    from elasticdl_tpu_torch.master.journal import (
        JournalWriter,
        replay_journal,
    )
    from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
    from elasticdl_tpu_torch.master.scheduler import (
        JobRegistry,
        ManagedJob,
        MultiTenantMaster,
        ResizeController,
    )
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    names = [s.name for s in specs]
    sched_journal = None
    sched_state = None
    if args.journal_dir:
        sched_dir = os.path.join(args.journal_dir, "sched")
        # The recovery trace (same contract as the single-job path):
        # replaying the scheduler journal is this incarnation's root
        # recovery span; post-replay events link back to it so worker
        # outage rides and the restarted schedule stitch into one
        # incident component (the cpu_multitenant drill gate).
        with tracing.span("master.journal_replay") as replay_span:
            sched_state = replay_journal(sched_dir)
        if sched_state is not None:
            restart = sched_state.restarts + 1
            tracing.configure_identity(
                "master", generation=restart, restart=restart,
                link_trace=getattr(replay_span, "trace", None),
            )
        sched_journal = JournalWriter(sched_dir)
        sched_meta = {"jobs": names, "multitenant": True}
        if sched_state is not None:
            _check_journal_meta(sched_state, sched_meta)
            sched_journal.append({"ev": "restart"})
            sched_journal.flush()
        else:
            sched_journal.append({"ev": "meta", "job": sched_meta})
    registry = JobRegistry(
        journal=sched_journal, pool_size=args.num_workers
    )
    for index, spec in enumerate(specs):
        job_id = index + 1   # deterministic: spec order, 1-based (0 =
        #                      "unscoped" on the wire)
        records_per_task = spec.records_per_task
        reader = create_data_reader(
            spec.data_origin, records_per_shard=records_per_task
        )
        task_manager = TaskManager(
            training_shards=reader.create_shards(),
            records_per_task=records_per_task,
            num_epochs=spec.num_epochs,
            shuffle=spec.shuffle,
            shuffle_shards=spec.shuffle_shards,
            max_task_retries=args.max_task_retries,
            task_timeout_secs=args.task_timeout_secs,
            seed=spec.seed,
        )
        job_journal = None
        job_state = None
        if args.journal_dir:
            job_dir = os.path.join(args.journal_dir,
                                   "job-%02d" % job_id)
            job_state = replay_journal(job_dir)
            job_journal = JournalWriter(job_dir)
            if job_state is not None:
                _check_journal_meta(job_state, spec.journal_meta())
                task_manager.restore_from_journal(job_state)
                job_journal.append({"ev": "restart"})
                job_journal.flush()
                task_manager.attach_journal(job_journal,
                                            bootstrap=False)
            else:
                job_journal.append(
                    {"ev": "meta", "job": spec.journal_meta()}
                )
                task_manager.attach_journal(job_journal,
                                            bootstrap=True)
        rendezvous = None
        if spec.distribution_strategy == "collective":
            # Per-job epoch space.  No coordinator factory: pool
            # workers keep process-local meshes (the same regime the
            # elastic drills run); every join/leave still commits a
            # real journaled epoch for this job only.
            rendezvous = RendezvousServer(
                journal=job_journal,
                initial_epoch=(
                    job_state.rendezvous_id + 1 if job_state else 0
                ),
                name=spec.name,
            )
        servicer = MasterServicer(
            task_manager, rendezvous_server=rendezvous,
            journal=job_journal, job_id=job_id,
        )
        if job_state is not None:
            servicer.restore_from_journal(job_state)
        job = ManagedJob(
            job_id, spec, task_manager, servicer,
            rendezvous=rendezvous, journal=job_journal,
        )
        registry.submit(job, journal=sched_state is None)
    if sched_state is not None:
        registry.restore_from_journal(sched_state)
    controller = ResizeController(
        registry, worker_manager=worker_manager,
        cadence_secs=args.sched_cadence_secs,
        moves_per_tick=args.sched_moves_per_tick,
        worker_stale_secs=args.sched_worker_stale_secs,
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
    return MultiTenantMaster(
        registry, controller, worker_manager=worker_manager,
        port=port, sched_journal=sched_journal,
        interceptors=interceptors,
    )


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


def start_status_server(args, master):
    """The master's status server on ``--status_port`` (0 picks a free
    port), started; None when the flag is negative (off)."""
    if args.status_port < 0:
        return None
    from elasticdl_tpu_torch.master.status_server import StatusServer

    status_server = StatusServer(
        master.task_manager,
        worker_manager=master.worker_manager,
        rendezvous_server=master.rendezvous_server,
        servicer=master.servicer,
        port=args.status_port,
    )
    status_server.start()
    return status_server


def _advertise_on_relaunch(worker_manager, args):
    """Keep every launch of ``worker_manager`` dialling the advertised
    address.  ``MultiTenantMaster.prepare()`` (a copy of the reference's)
    points the manager at ``localhost:<port>``, which a k8s pod cannot
    reach; the address is rewritten as it is set, before ``prepare()``
    starts the manager, so no relaunch can read ``localhost`` (setting it
    back afterwards would race the relaunches)."""
    advertised = _advertise_addr(args)
    set_master_addr = worker_manager.set_master_addr

    def set_advertised(addr):
        host, _, port = addr.rpartition(":")
        if host == "localhost":
            addr = advertised.replace("%d", port)
        set_master_addr(addr)

    worker_manager.set_master_addr = set_advertised


def _run_multitenant(args):
    master = build_multitenant_master(args)
    if master.worker_manager is not None:
        _advertise_on_relaunch(master.worker_manager, args)
    master.prepare()
    if master.port_reservation is not None:
        master.port_reservation.close()  # the gRPC server holds the port
    _arm_master_slo(
        lambda: [job.servicer for job in master.registry.jobs()])
    status_server = None
    if args.status_port >= 0:
        from elasticdl_tpu_torch.master.status_server import (
            MultiTenantStatusServer,
        )

        status_server = MultiTenantStatusServer(
            master.registry, worker_manager=master.worker_manager,
            port=args.status_port,
        )
        status_server.start()
    try:
        return master.run()
    finally:
        if status_server is not None:
            status_server.stop()
        for job in master.registry.jobs():
            if job.journal is not None:
                job.journal.close()
        if master.sched_journal is not None:
            master.sched_journal.close()


def main(argv=None):
    args = parse_master_args(argv)
    tracing.configure_identity("master")
    tracing.arm_crash_dump()
    logger.info("master starting: %s", vars(args))
    check_ported(args)
    if args.jobs_spec:
        return _run_multitenant(args)
    master = build_master(args)
    master.prepare()
    if master.port_reservation is not None:
        master.port_reservation.close()  # the gRPC server holds the port
    _arm_master_slo(lambda: [master.servicer])
    status_server = start_status_server(args, master)
    if master.ps_manager is not None:
        # The shards report their versions to the master's service,
        # which serves since prepare().
        master.ps_manager._master_addr = "localhost:%d" % master.port
        master.ps_manager.start()
    try:
        return master.run()
    finally:
        if master.ps_manager is not None:
            master.ps_manager.stop()
        if status_server is not None:
            status_server.stop()
        if master.journal is not None:
            master.journal.close()


if __name__ == "__main__":
    raise SystemExit(main())
