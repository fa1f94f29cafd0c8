"""Iris DNN classifier from CSV (counterpart of
``elasticdl_tpu/models/iris.py``; the reference's model_zoo iris and
odps_iris): a simple tabular model.

``IrisDNN`` is the JAX ``IrisDNN``: Dense(16), ReLU, Dense(16), ReLU,
Dense(num_classes), under flax's call-order names, so
``spec.params_from_jax`` / ``params_to_jax`` map the JAX tree (kernels
``[in, out]`` <-> ``[out, in]``).  Weights follow flax's defaults
(``spec.init_flax_defaults_``); the optimizer is
``torch.optim.Adam(lr, eps=1e-8)``.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mnist import loss_fn
from elasticdl_tpu_torch.models.spec import (ModelSpec, init_flax_defaults_,
                                             params_from_jax, params_to_jax)
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device


class IrisDNN(nn.Module):
    def __init__(self, num_classes=3):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 16)
        self.Dense_1 = nn.Linear(16, 16)
        self.Dense_2 = nn.Linear(16, num_classes)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


def feed(records):
    """records: CSV rows [f0, f1, f2, f3, label]."""
    xs = np.asarray(
        [[float(v) for v in r[:4]] for r in records], np.float32
    )
    ys = np.asarray([int(float(r[4])) for r in records], np.int32)
    return xs, ys


def model_spec(learning_rate=0.01, num_classes=3):
    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        return init_flax_defaults_(IrisDNN(num_classes), seed).to(device)

    return ModelSpec(
        name="iris", init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, input_shape=(4,), loss_fn=loss_fn,
        optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=lambda: {"accuracy": metrics.Accuracy()},
    )


def synthetic_iris_csv(path, n=150, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3],
                        [6.6, 3.0, 5.6, 2.1]])
    with open(path, "w") as f:
        for _ in range(n):
            y = rng.randint(3)
            x = centers[y] + rng.randn(4) * 0.25
            f.write(",".join("%.2f" % v for v in x) + ",%d\n" % y)
    return path
