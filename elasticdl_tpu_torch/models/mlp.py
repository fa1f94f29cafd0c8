"""Shared He-init MLP (counterpart of ``elasticdl_tpu/models/mlp.py``):
the ``w%d``/``b%d`` dense stack the tabular zoo models import.

The names are the reference's, part of those models' checkpoint
format.  A kernel ``w%d`` is kept as a torch dense weight, ``[out, in]``,
the 2-D layout ``spec.to_jax_layout`` / ``spec.from_jax_layout``
transpose to and from the JAX package's ``[in, out]``; so
``{k: from_jax_layout(v)}`` of a JAX tree is a parameter dict here.
"""

import torch
import torch.nn.functional as F


def mlp_init(sizes, generator):
    """He-initialized params {"w0", "b0", ...} for the layer widths
    ``sizes`` ([in, hidden..., out]): normal weights of std
    sqrt(2 / fan_in) drawn from ``generator`` (a ``torch.Generator``),
    zero biases, float32 on the generator's device."""
    params = {}
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        params["w%d" % i] = torch.randn(
            (fan_out, fan_in), generator=generator,
            device=generator.device) * (2.0 / fan_in) ** 0.5
        params["b%d" % i] = torch.zeros(fan_out, device=generator.device)
    return params


def mlp_apply(params, x):
    """Dense stack with ReLU between layers (linear final layer).
    Ignores params outside the w%d/b%d convention, so models may mix
    extra keys (e.g. a global "bias") into the same dict."""
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers):
        x = F.linear(x, params["w%d" % i], params["b%d" % i])
        if i < n_layers - 1:
            x = torch.relu(x)
    return x
