"""A collective minibatch that fails its re-rendezvous retries ends the
port's worker (``CollectiveFailure``, elasticdl_tpu_torch/worker/
worker.py), on the CPU.

The reference's worker breaks out of the minibatch, reports the task
failed and keeps running (elasticdl_tpu/worker/worker.py:374-375,
:511); the port's raises ``CollectiveFailure`` after three attempts, so
the worker process exits non-zero and its manager relaunches it into a
fresh world (ROADMAP Queue C, documented differences).  Here a real
port master serves one task to a ``Worker`` whose collective world (a
stand-in elastic controller at world size 2) fails every step: each
failed attempt waits for a new epoch, finds none and forces a re-init;
the third raises out of the worker's entry point, and the task is back
on the master's queue with one retry charged.
"""

import signal

import pytest

from elasticdl_tpu_torch.data.reader import ArrayDataReader
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import CollectiveFailure, Worker


class BrokenWorld:
    """An elastic controller whose world of 2 never comes back: no new
    epoch arrives, and every forced re-init leaves it broken."""

    world_size = 2

    def __init__(self):
        self.calls = []

    def step_check(self, n=1):
        self.calls.append("step_check")

    def await_new_epoch(self):
        self.calls.append("await_new_epoch")
        return False

    def init_world_if_needed(self, force=False):
        self.calls.append("init_world(force=%s)" % force)

    def leave_world(self):
        self.calls.append("leave_world")

    def rejoin_world(self):
        self.calls.append("rejoin_world")


def test_collective_failure_ends_the_worker_with_its_task_requeued(
        monkeypatch):
    xs, ys = mnist.synthetic_data(n=64, seed=2)
    reader = ArrayDataReader((xs, ys), records_per_shard=64)
    task_manager = TaskManager(training_shards=reader.create_shards(),
                               records_per_task=64)
    master = Master(task_manager)
    master.prepare()
    previous_sigterm = signal.getsignal(signal.SIGTERM)
    try:
        addr = "localhost:%d" % master.port
        channel = grpc_utils.build_channel(addr)
        mc = MasterClient(channel, worker_id=0, addr=addr)
        spec = mnist.model_spec()
        trainer = CollectiveTrainer(spec, batch_size=32, device="cpu")
        steps = []

        def failing_step(features, labels):
            steps.append(len(labels))
            raise RuntimeError("gloo: connection reset by peer")

        monkeypatch.setattr(trainer, "train_minibatch", failing_step)
        world = BrokenWorld()
        worker = Worker(mc, reader, spec, trainer, batch_size=32,
                        elastic_controller=world)
        worker.launch_ledger = worker_main.LaunchLedger()
        worker.launch_ledger.start(None, trainer)
        monkeypatch.setattr(worker_main, "build_worker", lambda args: worker)
        # The entry point would stamp this test process as a worker.
        monkeypatch.setattr(worker_main.tracing, "configure_identity",
                            lambda *a, **k: None)
        # Uncaught, the exception ends ``python -m ...worker.main`` with
        # a non-zero exit code.
        with pytest.raises(CollectiveFailure, match="after 3 re-rendezvous"):
            worker_main.main(["--worker_id", "0"])
        assert steps == [32, 32, 32]
        assert world.calls == [
            "step_check", "await_new_epoch", "init_world(force=True)",
            "step_check", "await_new_epoch", "init_world(force=True)",
            "step_check"]
        counts = task_manager.counts()
        assert counts["todo"] == 1 and counts["doing"] == 0
        assert counts["completed"][int(pb.TRAINING)] == 0
        assert sum(counts["failed"].values()) == 0
        task = task_manager.get(1)
        assert task is not None and task.retry_count == 1
        assert task.shard.start == 0 and task.shard.end == 64
        channel.close()
    finally:
        signal.signal(signal.SIGTERM, previous_sigterm)
        master.stop()
