"""The port's wrap-your-own-loop example (elasticdl_tpu_torch/models/
mnist_torch.py: a stock torch loop over an ``ElasticDataset`` under the
elastic controller), against the port's master on the CPU: the port of
tests/test_torch_elastic.py (which tests the JAX package's example), and
the JAX package's loop from the same initial weights.

Tolerance: the final loss within 1e-6 of the reference's (the same
float32 Adam steps on the same CPU over the same record order; both
run torch).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models import mnist_torch
from tests.test_torch_elastic_controller import (
    create_master,
    create_master_client,
)

LOSS_ATOL = 1e-6


def run_port(**kwargs):
    master = create_master([("mem", 0, 512)], records_per_task=64)
    try:
        loss, batches = mnist_torch.train(
            create_master_client(master), n_records=512, batch_size=32,
            device="cpu", **kwargs)
        return loss, batches, master.task_manager.finished()
    finally:
        master.stop()


def test_torch_elastic_loop_completes_and_learns():
    loss, batches, finished = run_port()
    assert batches == 16
    assert np.isfinite(loss)
    assert finished


def test_initial_weights_come_from_the_seed():
    a, b = mnist_torch.build_torch_model(3), mnist_torch.build_torch_model(3)
    c = mnist_torch.build_torch_model(4)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        assert not torch.equal(p, r), name
    # nn.Linear's ranges: |w| <= 1/sqrt(fan_in), |b| <= 1/sqrt(fan_in).
    for layer in (a[1], a[3]):
        bound = layer.in_features ** -0.5
        assert float(layer.weight.detach().abs().max()) <= bound
        assert float(layer.bias.detach().abs().max()) <= bound


def test_matches_the_jax_package_loop(monkeypatch):
    """The JAX package's ``mnist_torch.train`` over its own master, its
    ``build_torch_model`` handing back the port's initial weights: the
    same number of batches and the same final loss."""
    from elasticdl_tpu.models import mnist_torch as ref
    from tests.test_utils import create_master as jax_master
    from tests.test_utils import create_master_client as jax_client

    init = mnist_torch.build_torch_model(0).state_dict()

    def build():
        model = torch.nn.Sequential(
            torch.nn.Flatten(), torch.nn.Linear(28 * 28, 128),
            torch.nn.ReLU(), torch.nn.Linear(128, 10))
        model.load_state_dict(init)
        return model

    monkeypatch.setattr(ref, "build_torch_model", build)
    master = jax_master(training_shards=[("mem", 0, 512)],
                        records_per_task=64, rendezvous=True)
    try:
        want, want_batches = ref.train(jax_client(master), n_records=512,
                                       batch_size=32)
        assert master.task_manager.finished()
    finally:
        master.stop()
    got, batches, finished = run_port(state_dict=init)
    assert finished and batches == want_batches == 16
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
