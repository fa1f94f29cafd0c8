"""The port's master/worker path in one process (``elasticdl_tpu_torch/
master``, ``worker``, ``proto``, ``data``, ``utils/timing.py``), against
the JAX package's.

The harness is the reference's in-process cluster
(tests/test_worker_e2e.py, tests/test_utils.py): a real TaskManager, a
real gRPC master service on a localhost port, a real MasterClient and
Worker, all in this process, on the CPU.  The JAX side runs its own
harness on the same data; the two wires are one protocol, so each
package's worker also finishes a job served by the other's master.

Tolerances: a Worker's losses equal its direct trainer's bitwise (same
seed, same batches: the task loop adds no arithmetic), and fused-K
windows equal the per-step loop bitwise (the contract of
tests/test_fused_driver.py).  Against the JAX harness, losses agree at
rtol 2e-4, the tolerance of tests/test_torch_trainer.py.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticdl_tpu.models import mnist as jmnist
from elasticdl_tpu.proto import elastic_pb2 as jpb
from elasticdl_tpu.utils import timing as jtiming
from elasticdl_tpu.utils.pytree import to_numpy
from elasticdl_tpu.utils.pytree import unflatten_from_names as junflatten
from elasticdl_tpu.worker.collective_trainer import (
    CollectiveTrainer as JTrainer)
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.reader import ArrayDataReader
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.utils import timing as ttiming
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient
from elasticdl_tpu_torch.worker.worker import Worker
from tests import test_utils as jharness


@pytest.fixture(scope="module")
def dataset():
    return mnist.synthetic_data(n=256, seed=1)


def create_master(training_shards, records_per_task=64, num_epochs=1):
    """The port's in-process master (tests/test_utils.py:13-42)."""
    master = Master(TaskManager(training_shards=training_shards,
                                records_per_task=records_per_task,
                                num_epochs=num_epochs))
    master.prepare()
    return master


def create_master_client(port, worker_id=0):
    channel = grpc_utils.build_channel("localhost:%d" % port)
    grpc_utils.wait_for_channel_ready(channel)
    return MasterClient(channel, worker_id=worker_id)


def recording(trainer, method="train_minibatch"):
    """Wrap ``trainer.<method>`` so every returned loss (a scalar, or a
    window's losses) is kept; returns the list it fills."""
    losses, inner = [], getattr(trainer, method)

    def wrapped(*args, **kwargs):
        loss, version = inner(*args, **kwargs)
        losses.append(loss)
        return loss, version

    setattr(trainer, method, wrapped)
    return losses


def flat(losses):
    return np.concatenate([np.asarray(loss, np.float32).reshape(-1)
                           for loss in losses])


def run_port_job(dataset, num_epochs=2, **trainer_kwargs):
    xs, ys = dataset
    reader = ArrayDataReader((xs, ys), records_per_shard=64)
    master = create_master(reader.create_shards(), num_epochs=num_epochs)
    try:
        mc = create_master_client(master.port)
        spec = mnist.model_spec(learning_rate=5e-3)
        trainer = CollectiveTrainer(spec, batch_size=32, master_client=mc,
                                    device="cpu", **trainer_kwargs)
        batches = []
        inner = trainer.train_minibatch

        def train_minibatch(features, labels):
            batches.append((np.array(features), np.array(labels)))
            return inner(features, labels)

        trainer.train_minibatch = train_minibatch
        losses = recording(trainer)
        Worker(mc, reader, spec, trainer, batch_size=32).run()
        assert master.task_manager.finished()
        return master, trainer, losses, batches
    finally:
        master.stop()


def test_training_completes_all_tasks(dataset):
    master, trainer, _, _ = run_port_job(dataset)
    counts = master.task_manager.counts()
    assert counts["completed"][pb.TRAINING] == 8  # 4 shards x 2 epochs
    assert counts["failed"][pb.TRAINING] == 0
    assert trainer.version == 16  # 2 batches per task


def test_worker_death_tasks_recovered(dataset):
    """A worker dies holding a task; a second worker finishes all."""
    xs, ys = dataset
    reader = ArrayDataReader((xs, ys), records_per_shard=64)
    master = create_master(reader.create_shards())
    try:
        spec = mnist.model_spec()
        mc1 = create_master_client(master.port, worker_id=1)
        task = mc1.get_task()  # worker 1 takes a task and never reports
        assert task.id > 0
        master.task_manager.recover_tasks(1)
        mc2 = create_master_client(master.port, worker_id=2)
        trainer = CollectiveTrainer(spec, batch_size=32, device="cpu")
        Worker(mc2, reader, spec, trainer, batch_size=32).run()
        assert master.task_manager.finished()
        counts = master.task_manager.counts()
        assert counts["completed"][pb.TRAINING] == 4
        assert counts["failed"][pb.TRAINING] == 0
        assert trainer.version == 8
    finally:
        master.stop()


def test_worker_losses_equal_the_direct_trainer_and_the_jax_harness(
        dataset):
    """The task loop adds nothing to a step: the Worker's losses equal
    the port's trainer driven directly on the same batches, bitwise; and
    the JAX harness (JAX master, Worker and trainer), given the port's
    initial parameters, trains to the same losses over the first epoch.
    (Past it the loss falls to ~0.02 and Adam's sqrt(nu) division grows
    the two packages' last-bit differences past rtol 2e-4, as
    tests/test_torch_trainer.py describes.)"""
    _, trainer, losses, batches = run_port_job(dataset)
    assert len(batches) == 16
    direct = CollectiveTrainer(mnist.model_spec(learning_rate=5e-3),
                               batch_size=32, device="cpu")
    init = direct.export_parameters()
    want = [direct.train_minibatch(*b)[0] for b in batches]
    np.testing.assert_array_equal(flat(losses), flat(want))
    for name, value in direct.export_parameters().items():
        np.testing.assert_array_equal(
            trainer.export_parameters()[name], value, err_msg=name)

    xs, ys = dataset
    from elasticdl_tpu.data.reader import ArrayDataReader as JReader

    reader = JReader((xs, ys), records_per_shard=64)
    master = jharness.create_master(training_shards=reader.create_shards(),
                                    records_per_task=64, num_epochs=1)
    try:
        mc = jharness.create_master_client(master)
        jspec = jmnist.model_spec(learning_rate=5e-3)
        jtrainer = JTrainer(jspec, batch_size=32, master_client=mc)
        jtrainer.set_params(junflatten(to_numpy(jtrainer.params), init))
        jlosses = recording(jtrainer)
        JWorker(mc, reader, jspec, jtrainer, batch_size=32).run()
        assert master.task_manager.finished()
    finally:
        master.stop()
    assert len(jlosses) == 8
    np.testing.assert_allclose(flat(losses)[:8], flat(jlosses), rtol=2e-4)


# -- the wire: one protocol, either package's master -----------------------


def test_descriptor_is_byte_equal_to_the_reference():
    assert pb.DESCRIPTOR.name == jpb.DESCRIPTOR.name == "elastic.proto"
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb


def test_port_worker_finishes_a_jax_masters_job(dataset):
    xs, ys = dataset
    reader = ArrayDataReader((xs, ys), records_per_shard=64)
    master = jharness.create_master(training_shards=reader.create_shards(),
                                    records_per_task=64)
    try:
        mc = create_master_client(master.port)
        spec = mnist.model_spec()
        trainer = CollectiveTrainer(spec, batch_size=32, master_client=mc,
                                    device="cpu")
        Worker(mc, reader, spec, trainer, batch_size=32).run()
        assert master.task_manager.finished()
        counts = master.task_manager.counts()
        assert counts["completed"][jpb.TRAINING] == 4
        assert counts["failed"][jpb.TRAINING] == 0
        assert trainer.version == 8
    finally:
        master.stop()


def test_jax_worker_finishes_the_ports_masters_job(dataset):
    from elasticdl_tpu.data.reader import ArrayDataReader as JReader

    xs, ys = dataset
    reader = JReader((xs, ys), records_per_shard=64)
    master = create_master(reader.create_shards())
    try:
        mc = jharness.create_master_client(master)
        jspec = jmnist.model_spec()
        jtrainer = JTrainer(jspec, batch_size=32, master_client=mc)
        JWorker(mc, reader, jspec, jtrainer, batch_size=32).run()
        assert master.task_manager.finished()
        counts = master.task_manager.counts()
        assert counts["completed"][pb.TRAINING] == 4
        assert counts["failed"][pb.TRAINING] == 0
        assert jtrainer.version == 8
    finally:
        master.stop()


# -- fused windows (the contract of tests/test_fused_driver.py) -------------


class FakeMasterClient:
    """A task queue that records every progress and version report
    (tests/test_fused_driver.py:32-73)."""

    def __init__(self, sizes, worker_id=0):
        self.worker_id = worker_id
        self._tasks = [
            SimpleNamespace(
                id=i + 1, type=pb.TRAINING,
                shard=SimpleNamespace(name="s", start=sum(sizes[:i]),
                                      end=sum(sizes[:i]) + size,
                                      record_indices=[]),
                model_version=-1)
            for i, size in enumerate(sizes)]
        self.batch_done_calls = []
        self.task_results = []
        self.versions = []

    def get_task(self, task_type=None):
        if self._tasks:
            return self._tasks.pop(0)
        return SimpleNamespace(id=-1, type=-1, shard=None, model_version=-1)

    def report_batch_done(self, count, telemetry=None):
        self.batch_done_calls.append(count)

    def report_task_result(self, task_id, err_message="",
                           exec_counters=None, requeue=False):
        self.task_results.append((task_id, err_message, requeue))

    def report_version(self, version):
        self.versions.append(version)


def run_fake_job(fused_steps, accum_steps=1, n=320, per_shard=160):
    """Two tasks of 5 batches, version reports every 4 steps: K=4 runs
    windows of 4, 1, 3, 2 (clamped to the report boundary and the
    task's end)."""
    xs, ys = mnist.synthetic_data(n=n, seed=1)
    reader = ArrayDataReader((xs, ys), records_per_shard=per_shard)
    mc = FakeMasterClient([per_shard] * (n // per_shard))
    spec = mnist.model_spec(learning_rate=1e-3)
    trainer = CollectiveTrainer(spec, batch_size=32 // accum_steps,
                                accum_steps=accum_steps, master_client=mc,
                                report_version_steps=4, device="cpu")
    step_losses = recording(trainer)
    window_losses = recording(trainer, "train_window")
    worker = Worker(mc, reader, spec, trainer, batch_size=32,
                    fused_steps=fused_steps, log_loss_steps=4)
    worker.run()
    return mc, trainer, worker, flat(step_losses + window_losses)


@pytest.mark.parametrize("fused_steps,accum_steps", [(2, 1), (4, 1), (2, 2)])
def test_fused_windows_equal_the_per_step_loop_bitwise(fused_steps,
                                                       accum_steps):
    mc_ref, ref, worker_ref, want = run_fake_job(1, accum_steps)
    mc, fused, worker, got = run_fake_job(fused_steps, accum_steps)
    assert worker_ref._windowed_driver() is None
    assert worker._windowed_driver() is not None
    assert len(got) == len(want) == 10
    np.testing.assert_array_equal(got, want)
    for name, value in ref.export_parameters().items():
        np.testing.assert_array_equal(fused.export_parameters()[name],
                                      value, err_msg=name)
    # Version reports land on the per-step loop's step numbers; records
    # are all counted, in fewer progress RPCs.
    assert mc.versions == mc_ref.versions == [4, 8]
    assert sum(mc.batch_done_calls) == sum(mc_ref.batch_done_calls) == 320
    assert len(mc.batch_done_calls) < len(mc_ref.batch_done_calls)
    counters = worker.timing.counters()
    assert counters["fused_steps_run"] == 10
    assert worker.timing.sync_fraction("window_dispatch",
                                       "loss_sync") is not None


def test_window_api_on_the_trainer():
    spec = mnist.model_spec(learning_rate=1e-3)
    a = CollectiveTrainer(spec, batch_size=8, device="cpu")
    b = CollectiveTrainer(spec, batch_size=8, device="cpu")
    xs, ys = mnist.synthetic_data(n=24, seed=3)
    prepared = [a.prepare_batch(xs[i:i + 8], ys[i:i + 8])
                for i in range(0, 24, 8)]
    assert a.max_window is None and a.steps_to_boundary() is None
    staged = a.stage_window(prepared)
    assert staged.size == 3 and len(staged.features) == 3
    losses, version = a.train_window(staged)
    assert losses.shape == (3,) and version == 3
    singles = [b.train_minibatch(xs[i:i + 8], ys[i:i + 8])[0]
               for i in range(0, 24, 8)]
    np.testing.assert_array_equal(losses.numpy(), flat(singles))
    # build_fused_steps: K steps on one batch equal K single steps.
    p = prepared[0]
    last = a.build_fused_steps(2)(p.features, p.labels, p.weights)
    for _ in range(2):
        want, _ = b.train_minibatch(xs[:8], ys[:8])
    assert float(last) == float(want)
    assert a.zero1_report() is None
    a.close()


def test_prepare_batch_touches_no_device(monkeypatch):
    """Batch prep may run on the prefetch producer thread, so it never
    copies to the card: it returns CPU tensors even for a trainer whose
    device is not the CPU."""
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=8,
                                device="cpu")
    trainer._device = torch.device("meta")  # any copy would show
    xs, ys = mnist.synthetic_data(n=5, seed=2)
    prepared = trainer.prepare_batch(xs, ys)
    for t in (prepared.features, prepared.labels, prepared.weights):
        assert t.device.type == "cpu"
    assert prepared.features.shape[0] == 8 and prepared.count == 5
    staged = trainer.stage_window([prepared])
    assert staged.features.device.type == "meta"


@pytest.mark.parametrize("kwargs,steps", [
    # A cadence without an exporter exports nothing, as the JAX trainer.
    ({"export_steps": 4}, 0),
    ({"exporter": object(), "export_steps": 4}, 4)])
def test_trainer_export_options_are_ported(kwargs, steps):
    """Continuous export (A11): the trainer takes an exporter and its
    cadence (tests/test_torch_aggregation.py runs it)."""
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=8,
                                device="cpu", **kwargs)
    assert trainer._export_steps == steps


# -- Timing and data: the copies agree with the reference -------------------


def _scripted(timing_mod):
    t = timing_mod.Timing()
    t.bump("fused_windows")
    t.bump("fused_steps_run", 4)
    t.bump("zero1_all_gather_bytes", 64)
    t.observe("window_dispatch", 0.25)
    t.observe("loss_sync", 0.75, n=2)
    t.observe("step_time", 0.125, n=4)
    t.observe("step_time", 0.5)
    return t


def test_timing_matches_the_reference_on_one_call_sequence():
    got, want = _scripted(ttiming), _scripted(jtiming)
    assert got.counters() == want.counters()
    assert got.summary() == want.summary()
    assert (got.sync_fraction("window_dispatch", "loss_sync")
            == want.sync_fraction("window_dispatch", "loss_sync")
            == 1.5 / (1.5 + 0.25))
    assert got.histograms() == want.histograms()
    assert got.percentile("step_time", 0.5) == want.percentile(
        "step_time", 0.5)
    with got.timeit("batch_prep"):
        pass
    assert got.summary()["batch_prep"]["count"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """``device_trace`` is the reference's context manager over the port's
    ``torch.profiler`` adapter: one Chrome-trace JSON in the directory,
    named by role, worker id and pid, holding the block's ops."""
    with ttiming.device_trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = ttiming.PROFILER.last_trace
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).endswith("-%d.pt.trace.json"
                                           % os.getpid())
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert ttiming.PROFILER.last_export_s >= 0


@pytest.mark.parametrize("origin", [
    "synthetic_mnist:96", "synthetic_lm:40:16:64", "synthetic_cifar10:24"])
def test_data_factory_matches_the_reference(origin):
    from elasticdl_tpu.data.factory import create_data_reader as jcreate

    got = create_data_reader(origin, records_per_shard=32)
    want = jcreate(origin, records_per_shard=32)
    assert got.create_shards() == want.create_shards()
    task = SimpleNamespace(shard=SimpleNamespace(
        start=0, end=want.create_shards()[-1][2], record_indices=[]))
    for a, b in zip(got.read_records(task), want.read_records(task),
                    strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("origin", [
    "{d}/a.db", "imagefolder:{d}/images:8", "sql:{d}/a.db#t"])
def test_unported_data_origins_name_their_item(origin, tmp_path):
    """The origins that once raised NotImplementedError naming ROADMAP
    A22 (``.db``, ``sql:``, ``imagefolder:``) now build the port's
    copies of the readers, which read what the JAX factory's read."""
    from PIL import Image

    from elasticdl_tpu.data.factory import create_data_reader as jcreate
    from elasticdl_tpu_torch.data.sql_reader import SQLTableWriter

    for table in ("samples", "t"):
        writer = SQLTableWriter(str(tmp_path / "a.db"), table,
                                ["f0", "label"])
        writer.write([[float(i), i % 2] for i in range(7)])
        writer.close()
    rng = np.random.RandomState(0)
    for cls in ("a", "b"):
        (tmp_path / "images" / cls).mkdir(parents=True)
        for i in range(3):
            Image.fromarray((rng.rand(6, 5, 3) * 255).astype(np.uint8)).save(
                tmp_path / "images" / cls / ("%d.png" % i))
    origin = origin.format(d=tmp_path)
    got = create_data_reader(origin, records_per_shard=4)
    want = jcreate(origin, records_per_shard=4)
    assert got.create_shards() == want.create_shards()
    task = SimpleNamespace(shard=SimpleNamespace(
        start=0, end=want.create_shards()[-1][2], record_indices=[]))
    for a, b in zip(got.read_records(task), want.read_records(task),
                    strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
