"""ResNet family (counterpart of ``elasticdl_tpu/models/resnet.py``).

The public input is NHWC ``[B, H, W, 3]`` float32, as in the JAX
servable.  Inside, activations are NCHW tensors in
``torch.channels_last`` memory, so every conv output is NHWC in memory
and reaches the GroupNorm kernel as ``[B, HW, C]`` without a transpose
copy.  The weights are kept channels-last too, which makes the convs
keep that layout.

Submodules carry flax's call-order names (``Conv_0``, ``GroupNorm_0``,
``Bottleneck_0`` ... ``Bottleneck_15``, ``Dense_0``), so
``spec.params_from_jax`` / ``spec.params_to_jax`` map the JAX package's
``flatten_with_names`` names mechanically.

``init_fn(device, seed)`` draws the weights from the JAX model's
initializer families (conv kernels ``lecun_normal``, the Dense head
zero, GroupNorm scale 1 and bias 0), so a fresh model's first loss is
ln(num_classes) as in the JAX trainer.  The numbers themselves differ
from ``jax.random``'s.

Training (``loss_fn``, ``optimizer``) follows the JAX spec: softmax
cross-entropy on integer labels over float32 logits, and
``torch.optim.SGD(lr, momentum=0.9)``, which is ``optax.sgd(lr,
momentum=0.9)``: trace = g + 0.9 * trace, then p -= lr * trace.

Flax's ``padding="SAME"`` is TensorFlow's rule, which pads the extra
row and column at the END when the total is odd: the 3x3/2 conv of
each downsampling bottleneck and the stem's 3x3/2 max-pool pad (0, 1)
on even inputs, the s2d stem's 4x4/1 conv pads (1, 2).  Torch's
symmetric ``padding=1`` samples other positions, so every SAME pad here
is an explicit ``F.pad`` with TF amounts.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.models.spec import (ModelSpec, lecun_normal_,
                                             params_from_jax, params_to_jax)
from elasticdl_tpu_torch.ops.group_norm import fused_group_norm
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device


def _same_pads(size, kernel, stride):
    """TF "SAME": (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, value=0.0):
    hl, hh = _same_pads(x.shape[2], kernel, stride)
    wl, wh = _same_pads(x.shape[3], kernel, stride)
    if not (hl or hh or wl or wh):
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value).contiguous(
        memory_format=torch.channels_last)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` without bias: ``padding`` is "SAME" (TF rule) or
    explicit ((top, bottom), (left, right)) pairs; ``groups`` is flax's
    ``feature_group_count``."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 padding="SAME", groups=1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0, bias=False, groups=groups)
        self.same = padding == "SAME"
        self.pairs = None if self.same else padding

    def forward(self, x):
        if self.same:
            x = _pad_same(x, self.kernel_size[0], self.stride[0])
        else:
            (hl, hh), (wl, wh) = self.pairs
            x = F.pad(x, (wl, wh, hl, hh)).contiguous(
                memory_format=torch.channels_last)
        return super().forward(x)


class GroupNorm(nn.Module):
    """GroupNorm(+ReLU) on the CUDA kernel (ops/group_norm.py); params
    ``scale`` and ``bias`` as in flax.linen.GroupNorm."""

    def __init__(self, channels, num_groups, relu=False):
        super().__init__()
        self.num_groups = num_groups
        self.relu = relu
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # NCHW channels-last -> its NHWC view (no copy) and back.
        y = fused_group_norm(x.permute(0, 2, 3, 1), self.scale, self.bias,
                             self.num_groups, relu=self.relu)
        return y.permute(0, 3, 1, 2)


def _gn(channels, relu=False, groups=32):
    # group count that always divides the channel count
    return GroupNorm(channels, math.gcd(groups, channels), relu=relu)


class Bottleneck(nn.Module):
    def __init__(self, in_features, features, strides=1):
        super().__init__()
        out_features = features * 4
        self.Conv_0 = Conv(in_features, features, 1)
        self.GroupNorm_0 = _gn(features, relu=True)
        self.Conv_1 = Conv(features, features, 3, stride=strides)
        self.GroupNorm_1 = _gn(features, relu=True)
        self.Conv_2 = Conv(features, out_features, 1)
        self.GroupNorm_2 = _gn(out_features)
        self.shortcut = in_features != out_features or strides != 1
        if self.shortcut:
            self.Conv_3 = Conv(in_features, out_features, 1, stride=strides)
            self.GroupNorm_3 = _gn(out_features)

    def forward(self, x):
        residual = x
        y = self.GroupNorm_0(self.Conv_0(x))
        y = self.GroupNorm_1(self.Conv_1(y))
        y = self.GroupNorm_2(self.Conv_2(y))
        if self.shortcut:
            residual = self.GroupNorm_3(self.Conv_3(residual))
        return torch.relu(y + residual)


def space_to_depth(x, block=2):
    """[B, H, W, C] -> [B, H/b, W/b, C*b*b], in the JAX package's order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


class ResNet(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes=1000,
                 width=64, cifar_stem=False, s2d_stem=False):
        super().__init__()
        self.cifar_stem = cifar_stem
        self.s2d_stem = s2d_stem
        if cifar_stem:
            self.Conv_0 = Conv(3, width, 3)
        elif s2d_stem:
            # stride 1 on the s2d grid == stride 2 on the original
            self.Conv_0 = Conv(12, width, 4)
        else:
            self.Conv_0 = Conv(3, width, 7, stride=2,
                               padding=((3, 3), (3, 3)))
        self.GroupNorm_0 = _gn(width, relu=True)
        in_features = width
        index = 0
        for stage, blocks in enumerate(stage_sizes):
            features = width * (2 ** stage)
            for block in range(blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                setattr(self, "Bottleneck_%d" % index,
                        Bottleneck(in_features, features, strides))
                in_features = features * 4
                index += 1
        self.num_blocks = index
        self.Dense_0 = nn.Linear(in_features, num_classes)

    def forward(self, x):
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes]."""
        if self.s2d_stem:
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.GroupNorm_0(self.Conv_0(x))
        if not self.cifar_stem:
            # flax max_pool "SAME" pads with -inf
            x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
        for index in range(self.num_blocks):
            x = getattr(self, "Bottleneck_%d" % index)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def init_jax_family_(module, seed):
    """Draw a fresh ResNet's weights in place, from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        if name.endswith("Dense_0.weight") or name.endswith(".bias"):
            nn.init.zeros_(p)
        elif name.endswith(".scale"):
            nn.init.ones_(p)
        else:
            lecun_normal_(p, gen)
    return module


def loss_fn(logits, labels):
    """Per-example softmax cross-entropy, float32 (the JAX spec's
    ``optax.softmax_cross_entropy_with_integer_labels``)."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def _make_spec(name, input_shape, learning_rate, momentum=0.9,
               **model_kwargs):
    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        module = init_jax_family_(ResNet(**model_kwargs), seed)
        return module.to(device=device, memory_format=torch.channels_last)

    def apply_fn(module, x, train):
        # GroupNorm has no train/eval difference; train is accepted for
        # the zoo contract.
        return module(x)

    def feed(records):
        xs = np.stack(
            [np.asarray(r[0], dtype=np.float32) for r in records]
        )
        ys = np.asarray([int(r[1]) for r in records], dtype=np.int32)
        return xs, ys

    return ModelSpec(
        name=name, init_fn=init_fn, apply_fn=apply_fn, feed=feed,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax,
        input_shape=input_shape, loss_fn=loss_fn,
        optimizer=lambda params: torch.optim.SGD(
            params, lr=learning_rate, momentum=momentum),
        eval_metrics_fn=lambda: {"accuracy": metrics.Accuracy()})


def model_spec(variant="resnet50", num_classes=1000, image_size=224,
               learning_rate=0.1):
    """Zoo entry.  variant: resnet50 | resnet50_s2d | resnet50_cifar10 |
    resnet_small_cifar10."""
    if variant == "resnet50":
        return _make_spec("resnet50", (image_size, image_size, 3),
                          learning_rate, stage_sizes=(3, 4, 6, 3),
                          num_classes=num_classes)
    if variant == "resnet50_s2d":
        return _make_spec("resnet50_s2d", (image_size, image_size, 3),
                          learning_rate, stage_sizes=(3, 4, 6, 3),
                          num_classes=num_classes, s2d_stem=True)
    if variant == "resnet50_cifar10":
        return _make_spec("resnet50_cifar10", (32, 32, 3), learning_rate,
                          stage_sizes=(3, 4, 6, 3), num_classes=10,
                          cifar_stem=True)
    if variant == "resnet_small_cifar10":
        return _make_spec("resnet_small_cifar10", (32, 32, 3),
                          learning_rate, stage_sizes=(2, 2, 2, 2),
                          num_classes=10, cifar_stem=True)
    raise ValueError("unknown resnet variant %r" % variant)
