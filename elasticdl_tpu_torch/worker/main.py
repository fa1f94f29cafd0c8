"""Worker entrypoint (parity: elasticdl/python/worker/main.py:26-62;
counterpart of ``elasticdl_tpu/worker/main.py``).

Identity and topology arrive via env (``MASTER_ADDR``, ``WORKER_ID``) with
flag overrides; the model comes from the zoo contract by module name.

The device comes from ``ELASTICDL_TORCH_DEVICE`` (the variable the port's
server reads), ``cuda`` when it is unset: a worker launched with no
device variable runs on the card, and raises where there is none.  TF32
is turned off at entry (``use_float32_numerics``), so float32 work on
the card computes in float32.  The port runs the ``local`` strategy;
the PS trainer (ROADMAP A8), the collective mesh and elastic controller
(A4), ZeRO-1 (A6), continuous export (A11), device traces (A15) and
predict jobs (A21) raise ``NotImplementedError`` naming their item
(``utils.args.check_ported``).
"""

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
    compute and the version-report cadence come from the launch args."""
    saver = None
    checkpoint_steps = args.checkpoint_steps
    if args.checkpoint_dir:
        saver = CheckpointSaver(
            args.checkpoint_dir, keep_max=args.keep_checkpoint_max
        )
        if worker_id != 0:
            # Every worker may restore, but only worker 0 writes (the
            # collective path replicates params, so any single copy is
            # the model).
            checkpoint_steps = 0
    trainer = CollectiveTrainer(
        spec,
        batch_size=args.batch_size,
        master_client=mc,
        report_version_steps=max(1, args.evaluation_steps // 4)
        if args.evaluation_steps else 0,
        checkpoint_saver=saver,
        checkpoint_steps=checkpoint_steps,
        use_bf16_compute=args.use_bf16,
        rng_seed=args.seed,
        device=device,
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
    trainer = _build_collective_trainer(args, mc, spec, worker_id, device)
    logger.info("worker %d training on %s", worker_id, device)
    return Worker(
        mc, reader, spec, trainer,
        batch_size=args.batch_size,
        log_loss_steps=args.log_loss_steps,
        fused_steps=args.fused_steps,
        device_prefetch=args.device_prefetch,
    )


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
    worker.run()
    if worker.preempted:
        logger.info("worker preempted (checkpointed)")
        return PREEMPTED_EXIT_CODE
    logger.info("worker done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
