"""Worker entrypoint (parity: elasticdl/python/worker/main.py:26-62;
counterpart of ``elasticdl_tpu/worker/main.py``).

Identity and topology arrive via env (``MASTER_ADDR``, ``WORKER_ID``) with
flag overrides; the model comes from the zoo contract by module name.

The device comes from ``ELASTICDL_TORCH_DEVICE`` (the variable the port's
server reads), ``cuda`` when it is unset: a worker launched with no
device variable runs on the card, and raises where there is none.  TF32
is turned off at entry (``use_float32_numerics``), so float32 work on
the card computes in float32.  The port runs the ``local`` strategy
and the ``collective`` one: there the worker joins the master's
rendezvous, and the elastic controller (``api/controller.py``) re-forms
its ``torch.distributed`` world and data mesh at every epoch
(``parallel/distributed.py``), gloo on the same card for every rank;
``--zero1 true`` shards the optimizer state over that world (the
trainer's ZeRO-1; under ``local`` it trains alone, unsharded, as the JAX
worker does).  A predict job's outputs go to the spec's
``prediction_outputs_processor``, by default an ``NpzPredictionWriter``
into ``--prediction_outputs``; ``--profile_dir`` wraps the run in a
``torch.profiler`` trace (``utils.timing.device_trace``).  Under the
``ps`` strategy the worker trains through the ``ParameterServerTrainer``
against the shards in ``--ps_addrs`` (pulls and pushes ride a shard's
relaunch, ``utils.retry.ps_rpc_policy``), its step on the same device.
``--export_base D --export_steps N`` makes worker 0 alone (the
parameters are replicated, so its copy is the model) write a versioned
servable every N optimizer steps (``serving/export.ContinuousExporter``;
``--export_wire frame`` writes ``model.frame`` for the aggregation
tier, ``aggregation/main.py``).
A local-strategy worker of a multi-tenant pool (``--jobs_spec`` on the
master) rebuilds its reader, spec and trainer in place when the
scheduler moves it to another job (``_job_context_factory``).
On the card it compiles every kernel of ``ops/`` in the background as it
starts.  At exit the worker logs its kernel launches (``kernel launches: {...}``)
with the forward and backward passes its trainers ran, and each
trainer's share (``by_trainer``).
"""

import json
import os
import threading
import time

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.utils import grpc_utils, tracing
from elasticdl_tpu_torch.utils.args import check_ported, parse_worker_args
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.utils.device import (
    resolve_device,
    use_float32_numerics,
)
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import Worker

logger = get_logger(__name__)

DEVICE_ENV = "ELASTICDL_TORCH_DEVICE"


def worker_device():
    """The worker's device: ``$ELASTICDL_TORCH_DEVICE``, else ``cuda``
    (raises where CUDA is not available)."""
    return resolve_device(os.environ.get(DEVICE_ENV) or None)


def resolve_worker_id(args):
    """Flag wins, env fallback — the ONE resolution both the identity
    label and the MasterClient registration use (they must never name
    different workers)."""
    return (
        args.worker_id if args.worker_id >= 0
        else int(os.environ.get("WORKER_ID", 0))
    )


def _build_collective_trainer(args, mc, spec, worker_id, device,
                              batch_size=None, checkpoint_dir=None,
                              checkpoint_steps=None, seed=None):
    """The ONE CollectiveTrainer construction path — shared by the
    eager launch build and the multi-tenant job-switch factory, so a
    rebuilt worker can never silently train with different settings
    (checkpoint rules, bf16, ZeRO-1, version-report cadence) than a
    freshly launched one.  The keyword overrides are the job-config
    fields; everything unset falls back to the launch args."""
    batch_size = (
        args.batch_size if batch_size is None else int(batch_size)
    )
    checkpoint_dir = (
        args.checkpoint_dir if checkpoint_dir is None
        else checkpoint_dir
    )
    checkpoint_steps = (
        args.checkpoint_steps if checkpoint_steps is None
        else int(checkpoint_steps)
    )
    seed = args.seed if seed is None else int(seed)
    saver = None
    if checkpoint_dir:
        saver = CheckpointSaver(
            checkpoint_dir, keep_max=args.keep_checkpoint_max
        )
    exporter = None
    export_steps = getattr(args, "export_steps", 0)
    if getattr(args, "export_base", "") and export_steps:
        if worker_id != 0:
            # Same single-writer rule as checkpointing: the parameters
            # are replicated, so worker 0's exports are the model.
            export_steps = 0
        else:
            from elasticdl_tpu_torch.serving.export import (
                ContinuousExporter,
            )

            exporter = ContinuousExporter(
                args.export_base, model_name=args.job_name,
                wire_format=getattr(args, "export_wire", "npz"),
            )
    trainer = CollectiveTrainer(
        spec,
        batch_size=batch_size,
        master_client=mc,
        report_version_steps=max(1, args.evaluation_steps // 4)
        if args.evaluation_steps else 0,
        checkpoint_saver=saver,
        checkpoint_steps=checkpoint_steps,
        # Every worker may restore, but only worker 0 writes (the
        # parameters are replicated, so any single copy is the model);
        # under ZeRO-1 every rank still joins the cadence's gather.
        checkpoint_writer=worker_id == 0,
        use_bf16_compute=args.use_bf16,
        rng_seed=seed,
        device=device,
        zero1=args.zero1,
        exporter=exporter,
        export_steps=export_steps,
    )
    if saver is not None:
        trainer.init_from_checkpoint()
    return trainer


def _job_context_factory(args, mc, device, ledger):
    """Multi-tenant pools (docs/scheduler.md): build the callable the
    Worker invokes when the scheduler re-assigns it to a different job
    — rebuilds data reader, model spec and trainer from the handshake
    config, in place, without a process restart.  Wired for
    local-strategy pool workers; collective workers keep their elastic
    controller bound to one trainer, and PS workers keep their PS
    client topology, so both adopt re-assignments as an id only.  On
    the card it releases what the previous job left cached and logs the
    device memory still allocated when the new trainer's build starts
    (the Worker has dropped the old one) and once it is built;
    ``ledger`` counts each trainer's kernel launches."""
    if args.distribution_strategy != "local":
        return None

    worker_id = resolve_worker_id(args)

    def build(cfg):
        model_zoo = cfg.get("model_zoo", args.model_zoo)
        model_params = cfg.get("model_params", args.model_params)
        batch_size = int(cfg.get("batch_size", args.batch_size))
        records_per_task = batch_size * int(
            cfg.get("num_minibatches_per_task",
                    args.num_minibatches_per_task)
        )
        _release_device_caches(device)
        before = _device_bytes(device)
        spec = load_model_spec(model_zoo, model_params=model_params)
        reader = create_data_reader(
            cfg.get("data_origin", args.data_origin),
            records_per_shard=records_per_task,
        )
        # Job state lives with the job: a worker joining a
        # checkpointed job resumes that job's trajectory, a worker
        # joining an uncheckpointed one starts from the job's seeded
        # init (tenant isolation — nothing rides over from the
        # previous job's params).
        trainer = _build_collective_trainer(
            args, mc, spec, worker_id, device,
            batch_size=batch_size,
            checkpoint_dir=cfg.get("checkpoint_dir"),
            checkpoint_steps=cfg.get("checkpoint_steps"),
            seed=cfg.get("seed"),
        )
        ledger.start(cfg.get("job"), trainer)
        if before is not None:
            logger.info("job switch to %s: %d bytes allocated on %s "
                        "before its trainer was built, %d after",
                        cfg.get("job"), before, device,
                        _device_bytes(device))
        return reader, spec, trainer

    return build


def _initial_job_config(args):
    """The pool-template config this worker's eagerly-built pipeline
    corresponds to — lets the first handshake skip the rebuild when
    the assigned job matches the launch args.  Derived from the ONE
    field list the fast-path comparison uses, so the two can't
    drift."""
    return {
        field: getattr(args, field)
        for field in Worker._JOB_KEY_FIELDS
    }


def _device_bytes(device):
    """Bytes the caching allocator holds in live tensors on ``device``
    (None off the card)."""
    if device.type != "cuda":
        return None
    import torch

    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _release_device_caches(device):
    """Return what the previous job left cached on the card: the
    allocator's free blocks, and cuBLAS's workspaces (64 MiB on an H100
    once a matmul has run, live tensors to the allocator)."""
    if device.type != "cuda":
        return
    import torch

    torch.cuda.synchronize(device)
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces",
                               None)
    if clear_workspaces is not None:
        clear_workspaces()
    torch.cuda.empty_cache()


def _prebuild_kernels():
    """Compile every kernel of ``ops/`` in the background (one ``nvcc``
    per source, together), so that a worker on a cold build directory
    finds them built at its first step instead of building each on first
    use; libraries already built are loaded as they are, and a build
    another process holds is waited for (``ops/build.py``).  A failure
    is logged: the step that needs the kernel raises it again."""
    from elasticdl_tpu_torch.ops import build

    def run():
        start = time.perf_counter()
        try:
            outputs = build.build_all()
        except Exception as e:  # noqa: BLE001 — see the docstring
            logger.warning("kernel build failed: %s", e)
            return
        logger.info("kernels ready in %.1f s (%d of %d built by this "
                    "process)", time.perf_counter() - start,
                    sum(1 for text in outputs.values() if text),
                    len(outputs))

    thread = threading.Thread(target=run, name="kernel-build", daemon=True)
    thread.start()
    return thread


def build_worker(args):
    check_ported(args)
    device = worker_device()
    if device.type == "cuda":
        _prebuild_kernels()
    use_float32_numerics()
    master_addr = args.master_addr or os.environ.get("MASTER_ADDR", "")
    worker_id = resolve_worker_id(args)
    channel = grpc_utils.build_channel(master_addr)
    grpc_utils.connect_to_master(channel, master_addr)
    mc = MasterClient(channel, worker_id=worker_id, addr=master_addr)

    spec = load_model_spec(args.model_zoo,
                           model_params=args.model_params)
    records_per_task = args.batch_size * args.num_minibatches_per_task
    reader = create_data_reader(
        args.data_origin, records_per_shard=records_per_task
    )
    if args.job_type == "predict" and spec.prediction_outputs_processor \
            is None:
        from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
            NpzPredictionWriter,
        )

        spec.prediction_outputs_processor = NpzPredictionWriter(
            args.prediction_outputs
        )
    ledger = LaunchLedger()
    if args.distribution_strategy == "ps":
        worker = _build_ps_worker(args, mc, spec, reader, worker_id,
                                  device)
        ledger.start(None, worker.trainer)
        worker.launch_ledger = ledger
        return worker
    trainer = _build_collective_trainer(args, mc, spec, worker_id, device)
    ledger.start(None, trainer)
    logger.info("worker %d training on %s", worker_id, device)
    mem = trainer.zero1_report()
    if mem is not None:
        # What one rank holds in optimizer state under the chosen
        # placement (the trainer starts alone, so this shows only for a
        # trainer built over a world; rebuild() logs the ZeRO-1
        # placement at every re-form).
        logger.info(
            "optimizer state per device: %d bytes (%s, %d devices; "
            "replicated equivalent %d bytes, %.1fx)",
            mem["per_device_bytes"], mem["mode"], mem["num_shards"],
            mem["replicated_equiv_bytes"], mem["reduction_factor"],
        )
    collective = args.distribution_strategy == "collective"
    elastic = None
    if collective:
        # Managed elastic AllReduce: the controller consumes the master's
        # rendezvous epochs from inside the task loop, at the step
        # cadence; the trainer starts alone and is rebuilt over each
        # epoch's world (docs/designs/elastic_collectives.md).
        from elasticdl_tpu_torch.api.controller import (
            ElasticCollectiveController,
        )
        from elasticdl_tpu_torch.parallel.distributed import (
            collective_timeout_secs,
            data_mesh_builder,
        )

        check_steps = max(1, args.num_minibatches_per_task)
        elastic = ElasticCollectiveController(
            mc, trainer, check_steps=check_steps,
            mesh_builder=data_mesh_builder(
                device, collective_timeout_secs(check_steps)),
        )
    worker = Worker(
        mc, reader, spec, trainer,
        batch_size=args.batch_size,
        log_loss_steps=args.log_loss_steps,
        join_rendezvous=collective,
        elastic_controller=elastic,
        fused_steps=args.fused_steps,
        device_prefetch=args.device_prefetch,
        # Multi-tenant pools: rebuild the pipeline in place when the
        # scheduler re-assigns this worker to a different job.
        job_context_factory=_job_context_factory(args, mc, device,
                                                 ledger),
        initial_job_config=_initial_job_config(args),
    )
    worker.launch_ledger = ledger
    return worker


def _build_ps_worker(args, mc, spec, reader, worker_id, device):
    """A worker of the parameter-server strategy (the JAX worker's PS
    branch): the client rides a relaunched shard on its port, and the
    pipelined trainer pushes on connections of their own."""
    from elasticdl_tpu_torch.utils.retry import ps_rpc_policy
    from elasticdl_tpu_torch.worker.ps_client import build_ps_client
    from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer

    ps_client = build_ps_client(
        args.ps_addrs, wire_dtype=args.ps_wire_dtype,
        dedicated_push_channels=(
            args.use_async and args.async_push_window > 0
        ),
        retry=ps_rpc_policy(),
    )
    trainer = ParameterServerTrainer(
        spec, ps_client,
        batch_size=args.batch_size,
        master_client=mc,
        rng_seed=args.seed,
        atomic_sync=not args.use_async,
        async_push_window=args.async_push_window,
        # Every dense pull drains the push pipeline; a cadence > 1 is
        # what gives the async push room to overlap compute.
        get_model_steps=args.get_model_steps,
        device=device,
    )
    logger.info("worker %d training on %s against PS %s", worker_id,
                device, args.ps_addrs)
    return Worker(
        mc, reader, spec, trainer,
        batch_size=args.batch_size,
        log_loss_steps=args.log_loss_steps,
        fused_steps=args.fused_steps,
        device_prefetch=args.device_prefetch,
    )


def process_launches():
    """The process's kernel launch counters (``ops/``)."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import group_norm as gn

    return {"group_norm_fwd": gn.LAUNCHES, "group_norm_bwd": gn.BWD_LAUNCHES,
            "flash_fwd": fa.LAUNCHES, "flash_partial": fa.PARTIAL_LAUNCHES,
            "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES}


class LaunchLedger:
    """Kernel launches and the forward and backward passes
    (``train_passes``) of each trainer a worker ran, in order: a pool
    worker that switches jobs reports each trainer's share, so a
    ResNet-50 tenant's 53 B1 and B2 launches a pass stay readable after
    whatever the worker trained before it."""

    def __init__(self):
        self._trainers = []    # (job, trainer's Timing, counters at start)

    def start(self, job, trainer):
        """``trainer`` (serving ``job``; None: the launch args' job)
        runs from now on.  Keeps its ``Timing``, not the trainer."""
        self._trainers.append((job, trainer.timing, process_launches()))

    def report(self):
        """The process's totals, with ``by_trainer``: each trainer's
        launches and passes, and its job."""
        ends = [c for _, _, c in self._trainers[1:]] + [process_launches()]
        by_trainer = []
        for (job, timing, start), end in zip(self._trainers, ends):
            row = {k: end[k] - start[k] for k in end}
            row["train_passes"] = timing.counters().get("train_passes", 0)
            row["job"] = job
            by_trainer.append(row)
        out = process_launches()
        out["train_passes"] = sum(r["train_passes"] for r in by_trainer)
        out["by_trainer"] = by_trainer
        return out


def main(argv=None):
    import signal

    from elasticdl_tpu_torch.worker.worker import PREEMPTED_EXIT_CODE

    args = parse_worker_args(argv)
    # Structured process identity: every log line (and every flight-
    # recorder event) of an interleaved drill names its process.
    worker_id = resolve_worker_id(args)
    tracing.configure_identity("worker", rank=worker_id)
    logger.info("worker starting: %s", vars(args))
    worker = build_worker(args)

    def _graceful_preempt(_sig, _frame):
        # Preemptible hosts deliver SIGTERM with a grace window: finish
        # the in-flight minibatch, checkpoint, exit 143 (the manager
        # relaunches a replacement).
        logger.warning("SIGTERM received: graceful preemption")
        worker.request_stop()

    try:
        signal.signal(signal.SIGTERM, _graceful_preempt)
    except ValueError:
        pass  # not the main thread (embedded use)
    # AFTER the preemption hook so the SIGTERM chain is
    # dump-ring-then-graceful-preempt ($ELASTICDL_TRACE_DIR gates it).
    tracing.arm_crash_dump()
    try:
        if args.profile_dir:
            from elasticdl_tpu_torch.utils.timing import device_trace

            with device_trace(args.profile_dir):
                worker.run()
        else:
            worker.run()
    finally:
        logger.info("kernel launches: %s",
                    json.dumps(worker.launch_ledger.report()))
    if worker.preempted:
        logger.info("worker preempted (checkpointed)")
        return PREEMPTED_EXIT_CODE
    logger.info("worker done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
