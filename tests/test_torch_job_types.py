"""The port's predict job (``--job_type predict``), driven as a user drives
it: ``python -m elasticdl_tpu_torch.master.main`` with one worker
process on the CPU, after a train job of the same CLI wrote a
checkpoint; and the prediction writer against the reference's.

The predict job runs 5 tasks of 64 records on one worker.  Every record
of the data origin comes back exactly once across the ``*.npz`` files:
each row is matched to the record whose in-process forward (the port's
trainer restored from the same checkpoint) it equals, and the matching
is one to one.  Rows against that forward: 1e-5 absolute (the same
float32 model on the same CPU and batches, in a worker process with one
intra-op thread; measured 1.4e-6).  Rows
against the JAX package's mnist forward on the checkpoint's parameters:
1e-4 absolute, tests/test_torch_mobilenet.py's logits tolerance
(measured 1.7e-6).

The jobs run as tests/test_torch_process_path.py's do: outside the
repo, with stand-ins for ``jax`` and the JAX package that refuse to
import.
"""

import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    NpzPredictionWriter)
from tests.test_torch_process_path import Job, job_env  # noqa: F401

TRAIN_ARGS = ["--model_zoo", "mnist", "--batch_size", "32",
              "--num_workers", "1", "--num_minibatches_per_task", "4"]
PREDICT_ORIGIN = "synthetic_mnist:320"
PREDICT_ARGS = ["--model_zoo", "mnist", "--batch_size", "32",
                "--num_workers", "1", "--num_minibatches_per_task", "2"]
PREDICT_TASKS = 5
SELF_ATOL = 1e-5
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def checkpoint(job_env, tmp_path_factory):  # noqa: F811
    """A mnist train job of the port's CLI writes a checkpoint."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    job = Job(TRAIN_ARGS + ["--data_origin", "synthetic_mnist:256",
                            "--checkpoint_dir", ckpt,
                            "--checkpoint_steps", "4"], *job_env)
    assert job.finish(timeout=180) == 0, job.log
    assert CheckpointSaver(ckpt).latest_version() == 8, job.log
    return ckpt


def records_and_forward(origin, ckpt):
    """The origin's records in order, and the port trainer's forward of
    their features, restored from ``ckpt``."""
    reader = create_data_reader(origin, records_per_shard=64)
    end = reader.create_shards()[-1][2]
    task = SimpleNamespace(shard=SimpleNamespace(
        name=reader.create_shards()[0][0], start=0, end=end,
        record_indices=[]))
    xs, ys = mnist.feed(list(reader.read_records(task)))
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=32,
                                device="cpu",
                                checkpoint_saver=CheckpointSaver(ckpt))
    assert trainer.init_from_checkpoint()
    outs = np.concatenate([trainer.predict_minibatch(xs[i:i + 32])
                           for i in range(0, len(xs), 32)])
    return xs, ys, outs


def test_predict_job_writes_every_record_once(job_env, checkpoint,  # noqa: F811
                                              tmp_path):
    import jax

    from elasticdl_tpu.models import mnist as jmnist
    from elasticdl_tpu.utils.pytree import to_numpy, unflatten_from_names

    outputs = str(tmp_path / "preds")
    job = Job(PREDICT_ARGS + ["--job_type", "predict",
                              "--data_origin", PREDICT_ORIGIN,
                              "--checkpoint_dir", checkpoint,
                              "--prediction_outputs", outputs], *job_env)
    assert job.finish(timeout=180) == 0, job.log
    assert "restored checkpoint version 8" in job.log
    finished = next(line for line in job.log.splitlines()
                    if "job finished:" in line)
    # Task type 2 is PREDICTION (proto/elastic_pb2.py).
    assert "'completed': {0: 0, 1: 0, 2: %d, 4: 0}" % PREDICT_TASKS in (
        finished), finished
    assert "'failed': {0: 0, 1: 0, 2: 0, 4: 0}" in finished, finished
    files = sorted(glob.glob(os.path.join(outputs, "*.npz")))
    assert [os.path.basename(f) for f in files] == [
        "predictions-worker-0.npz"], job.log
    assert not glob.glob(os.path.join(outputs, "*.tmp-*"))
    rows = np.concatenate([np.load(f)["predictions"] for f in files])
    xs, _, want = records_and_forward(PREDICT_ORIGIN, checkpoint)
    assert len(xs) == 320 == PREDICT_TASKS * 64
    assert rows.shape == want.shape == (320, 10)
    # Each row is one record's forward, and each record has one row.
    dist = np.abs(rows[:, None, :] - want[None, :, :]).max(-1)
    match = dist.argmin(1)
    assert sorted(match.tolist()) == list(range(320))
    np.testing.assert_allclose(rows, want[match], atol=SELF_ATOL, rtol=0)
    # And the JAX model on the checkpoint's parameters agrees.
    named, _ = CheckpointSaver(checkpoint).load()
    jspec = jmnist.model_spec()
    params = unflatten_from_names(
        to_numpy(jspec.init_fn(jax.random.PRNGKey(0))),
        {k: v for k, v in named.items() if not k.startswith("opt/")})
    jax_rows = np.asarray(jspec.apply_fn(params, xs[match], False))
    np.testing.assert_allclose(rows, jax_rows, atol=JAX_ATOL, rtol=0)


def test_reference_writer_drops_earlier_tasks(tmp_path):
    """The JAX writer rewrites its file at each flush with that task's rows
    alone, so a worker that predicts two tasks keeps the last one's; the
    port's keeps both, and rewrites the file whole and atomically."""
    from elasticdl_tpu.worker.prediction_outputs_processor import (
        NpzPredictionWriter as JaxWriter)

    first = np.arange(40, dtype=np.float32).reshape(4, 10)
    second = -np.arange(30, dtype=np.float32).reshape(3, 10)
    files = {}
    for name, cls in (("jax", JaxWriter), ("port", NpzPredictionWriter)):
        writer = cls(str(tmp_path / name))
        writer.process(first, 7)
        writer.flush()                           # task 1 done
        writer.process(second, 7)
        path = writer.flush()                    # task 2 done
        assert os.path.basename(path) == "predictions-worker-7.npz"
        files[name] = np.load(path)["predictions"]
    np.testing.assert_array_equal(files["jax"], second)
    np.testing.assert_array_equal(files["port"],
                                  np.concatenate([first, second]))


def test_port_writer_flushes_only_new_rows_atomically(tmp_path,
                                                      monkeypatch):
    writer = NpzPredictionWriter(str(tmp_path))
    assert writer.flush() is None                # nothing yet
    writer.process(np.ones((2, 3), np.float32), 0)
    path = writer.flush()
    assert writer.flush() is None                # nothing new
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        replaced.append((os.path.basename(src), os.path.basename(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    writer.process(np.zeros((1, 3), np.float32), 0)
    assert writer.flush() == path
    assert replaced == [("predictions-worker-0.npz.tmp-%d" % os.getpid(),
                         "predictions-worker-0.npz")]
    assert np.load(path)["predictions"].shape == (3, 3)
    assert os.listdir(tmp_path) == ["predictions-worker-0.npz"]
    # A relaunched worker has a fresh id, so its file is another one.
    other = NpzPredictionWriter(str(tmp_path))
    other.process(np.full((1, 3), 5.0, np.float32), 1)
    other.flush()
    assert np.load(path)["predictions"].shape == (3, 3)
    assert sorted(os.listdir(tmp_path)) == [
        "predictions-worker-0.npz", "predictions-worker-1.npz"]
