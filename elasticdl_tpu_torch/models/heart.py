"""Heart-disease tabular classifier (counterpart of
``elasticdl_tpu/models/heart.py``; model_zoo heart parity: a 13-feature
CSV, a binary label).

``HeartDNN`` is the JAX ``HeartDNN``: Dense(32), ReLU, Dense(16), ReLU,
Dense(1).  Its layers carry flax's call-order names (``Dense_0`` ...),
so ``spec.params_from_jax`` / ``params_to_jax`` map the JAX tree, each
kernel ``[in, out]`` to the torch weight ``[out, in]``.  Weights follow
flax's defaults (``lecun_normal`` kernels, zero biases); the optimizer
is ``torch.optim.Adam(lr, eps=1e-8)``, the counterpart of ``optax.adam``.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.spec import (ModelSpec, init_flax_defaults_,
                                             params_from_jax, params_to_jax)
from elasticdl_tpu_torch.utils.device import resolve_device

NUM_FEATURES = 13


class HeartDNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(NUM_FEATURES, 32)
        self.Dense_1 = nn.Linear(32, 16)
        self.Dense_2 = nn.Linear(16, 1)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)[:, 0]


def feed(records):
    xs = np.asarray(
        [[float(v) for v in r[:NUM_FEATURES]] for r in records],
        np.float32,
    )
    ys = np.asarray(
        [int(float(r[NUM_FEATURES])) for r in records], np.int32
    )
    return xs, ys


def model_spec(learning_rate=0.005):
    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        return init_flax_defaults_(HeartDNN(), seed).to(device)

    return ModelSpec(
        name="heart", init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, input_shape=(NUM_FEATURES,),
        loss_fn=_ctr.loss_fn, optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=_ctr.eval_metrics,
    )


def synthetic_heart_csv(path, n=300, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            x = rng.randn(NUM_FEATURES)
            y = int(x[0] + 0.8 * x[3] - 0.5 * x[7] + rng.randn() * 0.3
                    > 0)
            f.write(",".join("%.3f" % v for v in x) + ",%d\n" % y)
    return path
