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
``torch.profiler`` trace (``utils.timing.device_trace``).  The PS
trainer (ROADMAP A8) and continuous export (A11) raise
``NotImplementedError`` naming their item (``utils.args.check_ported``).
At exit the worker logs its kernel launches (``kernel launches: {...}``)
with the forward and backward passes its trainer ran.
"""

import json
import os

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


def _build_collective_trainer(args, mc, spec, worker_id, device):
    """The ONE CollectiveTrainer construction path of the worker: the
    checkpoint rules (every worker restores, only worker 0 writes), bf16
    compute, ZeRO-1 and the version-report cadence come from the launch
    args."""
    saver = None
    if args.checkpoint_dir:
        saver = CheckpointSaver(
            args.checkpoint_dir, keep_max=args.keep_checkpoint_max
        )
    trainer = CollectiveTrainer(
        spec,
        batch_size=args.batch_size,
        master_client=mc,
        report_version_steps=max(1, args.evaluation_steps // 4)
        if args.evaluation_steps else 0,
        checkpoint_saver=saver,
        checkpoint_steps=args.checkpoint_steps,
        # Every worker may restore, but only worker 0 writes (the
        # parameters are replicated, so any single copy is the model);
        # under ZeRO-1 every rank still joins the cadence's gather.
        checkpoint_writer=worker_id == 0,
        use_bf16_compute=args.use_bf16,
        rng_seed=args.seed,
        device=device,
        zero1=args.zero1,
    )
    if saver is not None:
        trainer.init_from_checkpoint()
    return trainer


def build_worker(args):
    check_ported(args)
    device = worker_device()
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
    trainer = _build_collective_trainer(args, mc, spec, worker_id, device)
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
    return Worker(
        mc, reader, spec, trainer,
        batch_size=args.batch_size,
        log_loss_steps=args.log_loss_steps,
        join_rendezvous=collective,
        elastic_controller=elastic,
        fused_steps=args.fused_steps,
        device_prefetch=args.device_prefetch,
    )


def kernel_launches(trainer):
    """The process's kernel launch counters (``ops/``) and the forward
    and backward passes its trainer ran (``train_passes``): on the card
    B1/B2 launch 53 times a ResNet-50 pass."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import group_norm as gn

    return {"group_norm_fwd": gn.LAUNCHES, "group_norm_bwd": gn.BWD_LAUNCHES,
            "flash_fwd": fa.LAUNCHES, "flash_partial": fa.PARTIAL_LAUNCHES,
            "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
            "train_passes": trainer.timing.counters().get("train_passes", 0)}


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
                    json.dumps(kernel_launches(worker.trainer)))
    if worker.preempted:
        logger.info("worker preempted (checkpointed)")
        return PREEMPTED_EXIT_CODE
    logger.info("worker done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
