"""The port's CollectiveTrainer (elasticdl_tpu_torch/worker/
collective_trainer.py) against the JAX package's, single process on the
CPU.  Each JAX trainer is loaded with the port trainer's parameters,
then both take the same numpy-seeded batches.

Tolerances: losses at rtol 2e-4, the JAX package's own trainer tests'
(tests/test_collective_trainer.py); parameters at atol 1e-4.  Both
sides compute in float32 on the CPU and their convs sum in different
orders (XLA against oneDNN), about 1e-6 relative per layer.  Over three
steps the resnet's parameters drift apart by up to 3e-5 absolute (its
loss jumps from 2.3 to 11 at step 2, as the JAX trainer's does, which
amplifies the difference).  Adam divides each update by sqrt(nu), so a
gradient entry near zero whose last bits differ moves by a share of the
learning rate (1e-3): mnist's parameters drift by up to 1.4e-5.

The JAX ResNet runs its plain GroupNorm (the default on a CPU); the
port's gradients come from its own pullback (``_bwd_ref``), which
tests/test_torch_group_norm_bwd.py holds against the JAX kernel.
"""

import math

import numpy as np
import pytest
import torch

from elasticdl_tpu.models import mnist as jmnist
from elasticdl_tpu.models import resnet as jresnet
from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
from elasticdl_tpu.utils.pytree import flatten_with_names as jflatten
from elasticdl_tpu.utils.pytree import to_numpy
from elasticdl_tpu.utils.pytree import unflatten_from_names as junflatten
from elasticdl_tpu.worker.collective_trainer import (
    CollectiveTrainer as JTrainer)
from elasticdl_tpu_torch.models import mnist as tmnist
from elasticdl_tpu_torch.models import resnet as tresnet
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer

LR_RESNET = 0.01


def load_into_jax(jtrainer, named):
    """Give a JAX trainer the parameters ``{jax name: ndarray}``."""
    jtrainer.set_params(junflatten(to_numpy(jtrainer.params), named))


def assert_params_close(jtrainer, trainer, atol):
    want = jtrainer.export_parameters()
    got = trainer.export_parameters()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_resnet():
    """One JAX resnet_small_cifar10 trainer (its eager flax init costs
    most of this file's time) and a copy of its own initial params."""
    spec = jresnet.model_spec("resnet_small_cifar10",
                              learning_rate=LR_RESNET)
    trainer = JTrainer(spec, batch_size=4, rng_seed=0)
    return trainer, jflatten(to_numpy(trainer.params))[0]


def cifar_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


def test_resnet_sgd_momentum_matches_jax(jax_resnet, tmp_path):
    jtrainer, _ = jax_resnet
    spec = tresnet.model_spec("resnet_small_cifar10",
                              learning_rate=LR_RESNET)
    trainer = CollectiveTrainer(spec, batch_size=4, device="cpu",
                                checkpoint_saver=CheckpointSaver(
                                    str(tmp_path)))
    load_into_jax(jtrainer, trainer.export_parameters())
    xs, ys = cifar_batches(16)
    for i in range(3):
        batch = (xs[4 * i:4 * i + 4], ys[4 * i:4 * i + 4])
        want, _ = jtrainer.train_minibatch(*batch)
        got, version = trainer.train_minibatch(*batch)
        assert isinstance(got, torch.Tensor) and version == i + 1
        np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert_params_close(jtrainer, trainer, atol=1e-4)

    # The momentum (``opt/0/trace/...``) crosses too: a JAX trainer
    # restored from the port's checkpoint takes the port's next step.
    trainer.save_checkpoint()
    trainer.flush_checkpoints()
    jspec = jresnet.model_spec("resnet_small_cifar10",
                               learning_rate=LR_RESNET)
    resumed = JTrainer(jspec, batch_size=4, rng_seed=7,
                       checkpoint_saver=JSaver(str(tmp_path)))
    assert resumed.init_from_checkpoint() and resumed.version == 3
    want, _ = resumed.train_minibatch(xs[12:], ys[12:])
    got, _ = trainer.train_minibatch(xs[12:], ys[12:])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert_params_close(resumed, trainer, atol=1e-4)


def test_resnet_init_follows_the_jax_families(jax_resnet):
    _, jax_init = jax_resnet
    spec = tresnet.model_spec("resnet_small_cifar10")
    trainer = CollectiveTrainer(spec, batch_size=4, device="cpu")
    named = trainer.export_parameters()
    assert set(named) == set(jax_init)
    for name, value in named.items():
        if name.endswith("kernel") and value.ndim == 4:
            want = float(np.std(jax_init[name]))
            assert abs(float(np.std(value)) / want - 1) < 0.1, name
            # Truncated at two standard deviations of the underlying
            # normal, whose std is sqrt(1 / fan_in) / 0.8796.
            fan_in = int(np.prod(value.shape[:-1]))
            assert np.abs(value).max() <= 2 / 0.87962566 / fan_in ** 0.5
        else:
            np.testing.assert_array_equal(value, jax_init[name],
                                          err_msg=name)
    # Zero head: every logit is 0, the first loss is ln(num_classes).
    loss, _ = trainer.train_minibatch(*cifar_batches(4, seed=2))
    assert float(loss) == pytest.approx(math.log(10), rel=1e-6)
    # Another seed draws other numbers from the same families.
    other = CollectiveTrainer(spec, batch_size=4, device="cpu", rng_seed=1)
    assert not np.array_equal(other.export_parameters()["Conv_0/kernel"],
                              named["Conv_0/kernel"])


@pytest.fixture(scope="module")
def mnist_specs():
    return jmnist.model_spec(learning_rate=1e-3), tmnist.model_spec(
        learning_rate=1e-3)


def mnist_pair(mnist_specs, batch_size, **kwargs):
    jspec, spec = mnist_specs
    trainer = CollectiveTrainer(spec, batch_size=batch_size, device="cpu",
                                **kwargs)
    jtrainer = JTrainer(jspec, batch_size=batch_size)
    load_into_jax(jtrainer, trainer.export_parameters())
    return jtrainer, trainer


def test_mnist_adam_matches_jax(mnist_specs):
    jtrainer, trainer = mnist_pair(mnist_specs, 16, rng_seed=1)
    xs, ys = jmnist.synthetic_data(n=48, seed=3)
    for i in range(3):
        batch = (xs[16 * i:16 * i + 16], ys[16 * i:16 * i + 16])
        want, _ = jtrainer.train_minibatch(*batch)
        got, _ = trainer.train_minibatch(*batch)
        np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert_params_close(jtrainer, trainer, atol=1e-4)


def test_padded_partial_batch_matches_jax(mnist_specs):
    jtrainer, trainer = mnist_pair(mnist_specs, 16, rng_seed=2)
    xs, ys = jmnist.synthetic_data(n=40, seed=4)
    trainer.train_minibatch(xs[:16], ys[:16])
    jtrainer.train_minibatch(xs[:16], ys[:16])
    # 8 records, padded to 16 and masked out of the loss.
    want, _ = jtrainer.train_minibatch(xs[32:40], ys[32:40])
    got, _ = trainer.train_minibatch(xs[32:40], ys[32:40])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert_params_close(jtrainer, trainer, atol=1e-4)
    # The mask is exact: the padded step's loss is the mean over the 8.
    fresh = CollectiveTrainer(mnist_specs[1], batch_size=16, device="cpu")
    outputs, _ = fresh.evaluate_minibatch(xs[32:40], ys[32:40])
    per_example = torch.nn.functional.cross_entropy(
        torch.from_numpy(outputs), torch.from_numpy(ys[32:40]).long(),
        reduction="none")
    loss, _ = fresh.train_minibatch(xs[32:40], ys[32:40])
    np.testing.assert_allclose(float(loss), float(per_example.mean()),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="global batch"):
        fresh.train_minibatch(xs[:17], ys[:17])


def test_gradient_accumulation_matches_large_batch(mnist_specs):
    xs, ys = jmnist.synthetic_data(n=64, seed=5)
    spec = mnist_specs[1]
    big = CollectiveTrainer(spec, batch_size=64, device="cpu")
    accum = CollectiveTrainer(spec, batch_size=16, accum_steps=4,
                              device="cpu")
    for _ in range(2):
        loss_b, _ = big.train_minibatch(xs, ys)
        loss_a, _ = accum.train_minibatch(xs, ys)
        np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=2e-4)
    want, got = big.export_parameters(), accum.export_parameters()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                   rtol=0, err_msg=name)


def test_set_accum_steps_reshapes_and_masks(mnist_specs):
    trainer = CollectiveTrainer(mnist_specs[1], batch_size=16, device="cpu")
    xs, ys = jmnist.synthetic_data(n=40, seed=6)
    with pytest.raises(ValueError, match="global batch"):
        trainer.prepare_batch(xs, ys)
    trainer.set_accum_steps(4)
    prepared = trainer.prepare_batch(xs, ys)
    assert prepared.features.shape == (4, 16) + xs.shape[1:]
    assert prepared.labels.shape == (4, 16) and prepared.count == 40
    np.testing.assert_array_equal(prepared.weights.numpy().ravel(),
                                  np.arange(64) < 40)
    np.testing.assert_array_equal(
        prepared.features.reshape(64, *xs.shape[1:])[:40].numpy(), xs)


def test_jax_checkpoint_resumes_in_the_port(mnist_specs, tmp_path):
    """A JAX checkpoint (Adam moments included) restores into the port,
    which then follows JAX's uninterrupted loss curve."""
    jspec, spec = mnist_specs
    xs, ys = jmnist.synthetic_data(n=16, seed=11)
    ref = JTrainer(jspec, batch_size=16, rng_seed=4)
    losses_ref = [float(ref.train_minibatch(xs, ys)[0]) for _ in range(4)]

    t1 = JTrainer(jspec, batch_size=16, rng_seed=4,
                  checkpoint_saver=JSaver(str(tmp_path)),
                  checkpoint_steps=2)
    t1.train_minibatch(xs, ys)
    t1.train_minibatch(xs, ys)   # checkpoint at version 2
    t1.flush_checkpoints()

    port = CollectiveTrainer(spec, batch_size=16, device="cpu",
                             rng_seed=99,
                             checkpoint_saver=CheckpointSaver(str(tmp_path)))
    assert port.init_from_checkpoint() and port.version == 2
    resumed = [float(port.train_minibatch(xs, ys)[0]) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=2e-4)


def test_port_checkpoint_resumes_in_jax(mnist_specs, tmp_path):
    jspec, spec = mnist_specs
    xs, ys = jmnist.synthetic_data(n=16, seed=12)
    ref = CollectiveTrainer(spec, batch_size=16, device="cpu", rng_seed=5)
    losses_ref = [float(ref.train_minibatch(xs, ys)[0]) for _ in range(4)]

    t1 = CollectiveTrainer(spec, batch_size=16, device="cpu", rng_seed=5,
                           checkpoint_saver=CheckpointSaver(str(tmp_path)),
                           checkpoint_steps=2)
    t1.train_minibatch(xs, ys)
    t1.train_minibatch(xs, ys)   # checkpoint at version 2
    t1.flush_checkpoints()
    with np.load(tmp_path / "version-2" / "variables-0-of-1.ckpt") as z:
        assert z["dense/opt/0/count"].dtype == np.int32
        assert int(z["dense/opt/0/count"]) == 2

    jtrainer = JTrainer(jspec, batch_size=16, rng_seed=99,
                        checkpoint_saver=JSaver(str(tmp_path)))
    assert jtrainer.init_from_checkpoint() and jtrainer.version == 2
    resumed = [float(jtrainer.train_minibatch(xs, ys)[0]) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=2e-4)

    # And the port restores its own checkpoint onto the same curve.
    t2 = CollectiveTrainer(spec, batch_size=16, device="cpu", rng_seed=98,
                           checkpoint_saver=CheckpointSaver(str(tmp_path)))
    assert t2.init_from_checkpoint() and t2.version == 2
    again = [float(t2.train_minibatch(xs, ys)[0]) for _ in range(2)]
    np.testing.assert_allclose(again, losses_ref[2:], rtol=1e-6)


def test_incompatible_optimizer_state_starts_afresh(mnist_specs, tmp_path):
    """An Adam checkpoint restored by an SGD trainer keeps the params and
    re-initializes the optimizer, as the JAX trainer does."""
    _, spec = mnist_specs
    xs, ys = jmnist.synthetic_data(n=16, seed=13)
    saver = CheckpointSaver(str(tmp_path))
    adam = CollectiveTrainer(spec, batch_size=16, device="cpu",
                             checkpoint_saver=saver, checkpoint_steps=1)
    adam.train_minibatch(xs, ys)
    adam.flush_checkpoints()
    spec_sgd = tmnist.model_spec()
    spec_sgd.optimizer = lambda params: torch.optim.SGD(
        params, lr=0.1, momentum=0.9)
    sgd = CollectiveTrainer(spec_sgd, batch_size=16, device="cpu",
                            rng_seed=3, checkpoint_saver=saver)
    assert sgd.init_from_checkpoint() and sgd.version == 1
    for name, value in adam.export_parameters().items():
        np.testing.assert_array_equal(sgd.export_parameters()[name], value)
    assert not sgd._optimizer.state


def test_predict_and_evaluate_pad_and_trim(mnist_specs):
    _, spec = mnist_specs
    trainer = CollectiveTrainer(spec, batch_size=16, device="cpu")
    xs, ys = jmnist.synthetic_data(n=10, seed=14)
    outputs, labels = trainer.evaluate_minibatch(xs, ys)
    assert outputs.shape == (10, 10) and outputs.dtype == np.float32
    np.testing.assert_array_equal(labels, ys)
    np.testing.assert_array_equal(trainer.predict_minibatch(xs), outputs)
    metric = spec.eval_metrics_fn()["accuracy"]
    metric.update(outputs, labels)
    assert 0.0 <= metric.result() <= 1.0


def test_step_phases_are_timed(mnist_specs):
    trainer = CollectiveTrainer(mnist_specs[1], batch_size=16, device="cpu")
    xs, ys = jmnist.synthetic_data(n=16, seed=15)
    for _ in range(2):
        trainer.train_minibatch(xs, ys)
    summary = trainer.timing.summary()
    for phase in ("batch_prep", "step_dispatch"):
        assert summary[phase]["count"] == 2
        assert summary[phase]["total_s"] > 0
