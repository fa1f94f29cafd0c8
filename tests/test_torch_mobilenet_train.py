"""MobileNetV2 through the port's CollectiveTrainer on the CPU: SGD-momentum
checkpoints cross between the port and the JAX package's trainer both
ways, and two gloo ranks at batch 2 each take the step one process takes
at batch 4.

Checkpoints are compared bit for bit: parameters and the momentum
(``opt/0/trace/...``) restored on one side equal what the other side
saved.  The two-rank step: loss within 1e-6 relative and parameters
within 1e-6 absolute of the single process's (measured: the loss
equal, the parameters 1.2e-7 apart: the ranks' gradient all-reduce
sums the two halves of the batch in another order than one process's
backward; GroupNorm is per example, so the forward is the same row for
row).

Ranks are spawned processes (``parallel/launch.py``); this module
imports JAX only inside its tests, so the ranks never do.
"""

import dataclasses

import numpy as np
import torch.distributed as dist

from elasticdl_tpu_torch.models import mobilenet
from elasticdl_tpu_torch.parallel import launch
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import (
    CollectiveTrainer, _opt_state_to_jax)

LR = 0.05
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-6
RANKS_TIMEOUT_S = 240


def cifar(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


def port_trainer(ckpt_dir=None, **kwargs):
    return CollectiveTrainer(
        mobilenet.model_spec(learning_rate=LR), batch_size=4, device="cpu",
        checkpoint_saver=CheckpointSaver(ckpt_dir) if ckpt_dir else None,
        **kwargs)


def port_state(trainer):
    opt = _opt_state_to_jax(trainer._optimizer, trainer._named_params(),
                            trainer._spec.to_jax_layout)
    return trainer.export_parameters(), {k: np.asarray(v)
                                         for k, v in opt.items()}


def jax_trainer(ckpt_dir):
    """The JAX trainer over ``ckpt_dir``; its spec's init is jitted (the
    same numbers as the eager flax init, in a fraction of its time)."""
    import jax

    from elasticdl_tpu.models import mobilenet as jmobilenet
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
    from elasticdl_tpu.worker.collective_trainer import (
        CollectiveTrainer as JTrainer)

    spec = jmobilenet.model_spec(learning_rate=LR)
    spec = dataclasses.replace(spec, init_fn=jax.jit(spec.init_fn))
    return JTrainer(spec, batch_size=4, rng_seed=0,
                    checkpoint_saver=JSaver(ckpt_dir))


def jax_state(jtrainer):
    from elasticdl_tpu.utils.pytree import flatten_with_names, to_numpy

    trace = flatten_with_names(to_numpy(jtrainer._opt_state[0].trace))[0]
    return jtrainer.export_parameters(), {
        "0/trace/" + k: np.asarray(v) for k, v in trace.items()}


def assert_same(got, want):
    (gp, go), (wp, wo) = got, want
    assert sorted(gp) == sorted(wp) and len(gp) == 158
    for name in wp:
        np.testing.assert_array_equal(gp[name], wp[name], err_msg=name)
    traces = {k: v for k, v in go.items() if "/trace/" in k}
    assert sorted(traces) == sorted(wo) and len(traces) == 158
    for name in wo:
        np.testing.assert_array_equal(traces[name], wo[name], err_msg=name)
        assert np.abs(wo[name]).max() > 0, name    # a real momentum


def test_port_checkpoint_restores_in_the_jax_trainer(tmp_path):
    trainer = port_trainer(str(tmp_path))
    trainer.train_minibatch(*cifar(4, seed=5))
    trainer.save_checkpoint()
    trainer.flush_checkpoints()
    jtrainer = jax_trainer(str(tmp_path))
    assert jtrainer.init_from_checkpoint() and jtrainer.version == 1
    assert_same(port_state(trainer), jax_state(jtrainer))


def test_jax_checkpoint_restores_in_the_port_trainer(tmp_path):
    jtrainer = jax_trainer(str(tmp_path))
    jtrainer.train_minibatch(*cifar(4, seed=6))
    jtrainer.save_checkpoint()
    jtrainer.flush_checkpoints()
    trainer = port_trainer(str(tmp_path))
    assert trainer.init_from_checkpoint() and trainer.version == 1
    assert_same(port_state(trainer), jax_state(jtrainer))
    loss, version = trainer.train_minibatch(*cifar(4, seed=7))
    assert version == 2 and np.isfinite(float(loss))


def rank_step(xs, ys):
    """One rank of a 2-rank world: its half of the global batch of 4."""
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel.mesh import data_mesh

    rank = dist.get_rank()
    trainer = CollectiveTrainer(
        mobilenet.model_spec(learning_rate=LR), batch_size=2, device="cpu",
        mesh=data_mesh(backend=tdist.BACKEND, device="cpu"))
    loss, _ = trainer.train_minibatch(xs[2 * rank:2 * rank + 2],
                                      ys[2 * rank:2 * rank + 2])
    return (float(loss), trainer.process_count,
            trainer.export_parameters() if rank == 0 else None)


def test_two_gloo_ranks_equal_one_process_on_step_one():
    xs, ys = cifar(4, seed=8)
    single = port_trainer()
    want_loss = float(single.train_minibatch(xs, ys)[0])
    want = single.export_parameters()
    results = launch.spawn(rank_step, 2, (xs, ys), threads=1,
                           timeout=RANKS_TIMEOUT_S)
    for loss, procs, _ in results:
        assert procs == 2
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    got = results[0][2]
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)
