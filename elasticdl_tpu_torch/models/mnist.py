"""MNIST zoo model (counterpart of ``elasticdl_tpu/models/mnist.py``):
the default ``--model_zoo`` and the oracle model of the trainer tests.

``MnistCNN`` is the JAX ``MnistCNN``: two 3x3 SAME convs with bias, each
followed by ReLU and a 2x2 max-pool, then Dense(128), ReLU, Dense(10).
Flax flattens the NHWC map, so the port flattens in NHWC order too and
the ``Dense_0`` kernel maps one to one.  Weights follow flax's defaults
(``lecun_normal`` kernels, zero biases); the optimizer is
``torch.optim.Adam(lr, eps=1e-8)``, the counterpart of ``optax.adam``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.models.spec import (ModelSpec, init_flax_defaults_,
                                             params_from_jax, params_to_jax)
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device


class MnistCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(7 * 7 * 64, 128)
        self.Dense_1 = nn.Linear(128, 10)

    def forward(self, x):
        """x: [B, 28, 28] or [B, 28, 28, 1] -> logits [B, 10]."""
        x = x.reshape(x.shape[0], 1, 28, 28)
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def feed(records):
    xs = np.stack([np.asarray(r[0], dtype=np.float32) for r in records])
    ys = np.asarray([int(r[1]) for r in records], dtype=np.int32)
    return xs / 255.0 if xs.max() > 1.5 else xs, ys


def loss_fn(logits, labels):
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def model_spec(learning_rate=1e-3):
    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        return init_flax_defaults_(MnistCNN(), seed).to(device)

    def apply_fn(module, x, train):
        return module(x)

    return ModelSpec(
        name="mnist", init_fn=init_fn, apply_fn=apply_fn, feed=feed,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax,
        input_shape=(28, 28), loss_fn=loss_fn,
        optimizer=lambda params: torch.optim.Adam(
            params, lr=learning_rate, eps=1e-8),
        eval_metrics_fn=lambda: {"accuracy": metrics.Accuracy()})


def synthetic_data(n=512, seed=0):
    """Deterministic learnable synthetic digits for tests/benchmarks."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=n).astype(np.int32)
    xs = rng.rand(n, 28, 28).astype(np.float32) * 0.1
    for i in range(n):
        digit = ys[i]
        xs[i, 2 + digit : 6 + digit, 4:24] += 0.9  # class-dependent band
    return xs, ys
