"""MobileNetV2 (counterpart of ``elasticdl_tpu/models/mobilenet.py``):
the reference's second CIFAR-10 benchmark model
(docs/benchmark/ftlib_benchmark.md:45-51, 83-86: 2,236,682 params).

As ``models/resnet.py``: the public input is NHWC ``[B, H, W, 3]``
float32, activations inside are NCHW tensors in ``torch.channels_last``
memory, submodules carry flax's call-order names (``Conv_0``,
``GroupNorm_0``, ``InvertedResidual_0`` ... ``InvertedResidual_16``,
``Dense_0``) so ``spec.params_from_jax`` / ``spec.params_to_jax`` map
the JAX tree mechanically (the depthwise kernel HWIO ``(3, 3, 1, C)``
<-> ``(C, 1, 3, 3)`` like any conv kernel), and every SAME pad is TF's
rule (``resnet._pad_same``: (0, 1) for the 3x3/2 convs on even inputs).

The norms are flax's ``nn.GroupNorm`` with its defaults, not the B1
kernel's function: ``epsilon=1e-6`` and the fast variance
``max(0, E[x^2] - E[x]^2)``, both moments reduced in float32, where
``torch.nn.GroupNorm`` takes 1e-5 and a centred two-pass variance.
``GroupNorm`` below writes that formula out in plain torch ops; it runs
as such on the card too (the JAX package runs it as XLA ops, no Pallas
kernel).  ``num_groups`` is ``gcd(8, C)``.

Weights follow flax's defaults (``lecun_normal`` conv and Dense kernels,
zero biases, GroupNorm scale 1 and bias 0) drawn from ``seed``; the
optimizer is ``torch.optim.SGD(lr, momentum=0.9)``, which is
``optax.sgd(lr, momentum=0.9)``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.models.resnet import Conv, loss_fn
from elasticdl_tpu_torch.models.spec import (ModelSpec, lecun_normal_,
                                             params_from_jax, params_to_jax)
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device

EPSILON = 1e-6  # flax nn.GroupNorm's default


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` on an NCHW channels-last tensor:
    fast variance in float32 (float64 for a float64 ``x``, as flax
    promotes), ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    flax's order, returned in ``x``'s dtype."""

    def __init__(self, channels, num_groups, epsilon=EPSILON):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        # NCHW channels-last -> its NHWC view, groups split off C.
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.permute(0, 2, 3, 1).to(dtype).reshape(b, h * w, g, c // g)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.to(dtype).reshape(
            1, 1, g, c // g)
        y = (xf - mean) * mul + self.bias.to(dtype).reshape(1, 1, g, c // g)
        return y.reshape(b, h, w, c).to(x.dtype).permute(0, 3, 1, 2)


def _gn(channels):
    return GroupNorm(channels, math.gcd(8, channels))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, filters, stride, expand_ratio):
        super().__init__()
        hidden = in_ch * expand_ratio
        # flax names by call order: the expansion conv, when there is
        # one, is Conv_0 and shifts the depthwise and projection names.
        names = iter(range(3))
        self.expand = expand_ratio != 1
        if self.expand:
            i = next(names)
            setattr(self, "Conv_%d" % i, Conv(in_ch, hidden, 1))
            setattr(self, "GroupNorm_%d" % i, _gn(hidden))
        i = next(names)
        self.dw = "Conv_%d" % i, "GroupNorm_%d" % i
        setattr(self, self.dw[0], Conv(hidden, hidden, 3, stride=stride,
                                       groups=hidden))
        setattr(self, self.dw[1], _gn(hidden))
        i = next(names)
        self.proj = "Conv_%d" % i, "GroupNorm_%d" % i
        setattr(self, self.proj[0], Conv(hidden, filters, 1))
        setattr(self, self.proj[1], _gn(filters))
        self.residual = stride == 1 and in_ch == filters

    def forward(self, x):
        y = x
        if self.expand:
            y = F.relu6(self.GroupNorm_0(self.Conv_0(y)))
        conv, norm = (getattr(self, n) for n in self.dw)
        y = F.relu6(norm(conv(y)))
        conv, norm = (getattr(self, n) for n in self.proj)
        y = norm(conv(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    # (expand_ratio, channels, repeats, stride)
    CONFIG = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_classes=10, width_mult=1.0, cifar_stem=True):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width_mult))

        stem_stride = 1 if cifar_stem else 2
        self.Conv_0 = Conv(3, c(32), 3, stride=stem_stride)
        self.GroupNorm_0 = _gn(c(32))
        in_ch, index = c(32), 0
        for expand, ch, repeats, stride in self.CONFIG:
            for i in range(repeats):
                setattr(self, "InvertedResidual_%d" % index,
                        InvertedResidual(in_ch, c(ch),
                                         stride if i == 0 else 1, expand))
                in_ch = c(ch)
                index += 1
        self.num_blocks = index
        self.Conv_1 = Conv(in_ch, c(1280), 1)
        self.GroupNorm_1 = _gn(c(1280))
        self.Dense_0 = nn.Linear(c(1280), num_classes)

    def forward(self, x):
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes]."""
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu6(self.GroupNorm_0(self.Conv_0(x)))
        for index in range(self.num_blocks):
            x = getattr(self, "InvertedResidual_%d" % index)(x)
        x = F.relu6(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def init_flax_defaults_(module, seed):
    """Draw a fresh MobileNetV2's weights in place, from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        if name.endswith(".bias"):
            nn.init.zeros_(p)
        elif name.endswith(".scale"):
            nn.init.ones_(p)
        else:
            lecun_normal_(p, gen)
    return module


def model_spec(num_classes=10, image_size=32, learning_rate=0.05,
               cifar_stem=True):
    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        module = init_flax_defaults_(
            MobileNetV2(num_classes=num_classes, cifar_stem=cifar_stem),
            seed)
        return module.to(device=device, memory_format=torch.channels_last)

    def apply_fn(module, x, train):
        # GroupNorm has no train/eval difference.
        return module(x)

    def feed(records):
        xs = np.stack([np.asarray(r[0], np.float32) for r in records])
        ys = np.asarray([int(r[1]) for r in records], np.int32)
        return xs, ys

    return ModelSpec(
        name="mobilenetv2", init_fn=init_fn, apply_fn=apply_fn, feed=feed,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax,
        input_shape=(image_size, image_size, 3), loss_fn=loss_fn,
        optimizer=lambda params: torch.optim.SGD(
            params, lr=learning_rate, momentum=0.9),
        eval_metrics_fn=lambda: {"accuracy": metrics.Accuracy()})
