"""The port's ResNet (elasticdl_tpu_torch/models/resnet.py) against the
JAX package's, from the same numpy-seeded weights and inputs.

The JAX side runs its plain GroupNorm reference (ELASTICDL_FUSED_GN
"off").  Weights are random rather than the
JAX init, whose zero Dense kernel would make every logit 0.

Tolerance: 1e-4 abs/rel on the logits.  Both sides compute in float32
on the CPU; convs sum in different orders (XLA vs oneDNN), which moves
logits of order 1-10 by about 1e-5 after 50 layers.

The 64x64 inputs put every asymmetric TF-SAME pad on the path: the
stem max-pool (32 -> 16) and the three downsampling 3x3/2 convs pad
(0, 1), and the s2d stem's 4x4/1 conv pads (1, 2).
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import resnet as jresnet
from elasticdl_tpu.utils.pytree import flatten_with_names as jflatten
from elasticdl_tpu.utils.pytree import unflatten_from_names as junflatten
from elasticdl_tpu_torch.models import resnet as tresnet
from elasticdl_tpu_torch.utils import pytree as tpytree


@pytest.fixture(autouse=True)
def plain_jax_group_norm(monkeypatch):
    monkeypatch.setenv("ELASTICDL_FUSED_GN", "off")


def random_named(variant, image_size, seed=0):
    """JAX param names/shapes (from eval_shape: no init compute) ->
    He-scaled random weights, GN scale ~1, small biases."""
    spec = jresnet.model_spec(variant, image_size=image_size)
    shapes = jax.eval_shape(spec.init_fn, jax.random.PRNGKey(0))
    named, _ = jflatten(shapes)
    rng = np.random.RandomState(seed)
    values = {}
    for name, s in named.items():
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            values[name] = rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("scale"):
            values[name] = 1 + 0.1 * rng.randn(*s.shape)
        else:
            values[name] = 0.1 * rng.randn(*s.shape)
        values[name] = values[name].astype(np.float32)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    return spec, junflatten(template, values), values


@pytest.mark.parametrize("variant,size", [
    ("resnet_small_cifar10", 32),
    ("resnet50", 64),
    ("resnet50_s2d", 64),
])
def test_logits_match_jax(variant, size):
    jspec, params, named = random_named(variant, size)
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, x: jspec.apply_fn(p, x, False))(params, x))
    spec = tresnet.model_spec(variant, image_size=size)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    with torch.inference_mode():
        got = spec.apply_fn(module, torch.from_numpy(x), False).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_params_round_trip():
    _, params, named = random_named("resnet50", 64, seed=2)
    spec = tresnet.model_spec("resnet50", image_size=64)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    back = spec.params_to_jax(module)
    assert set(back) == set(named)
    for name, value in named.items():
        np.testing.assert_array_equal(back[name], value)
    # The port's flatten names the JAX params tree as JAX does.
    assert list(tpytree.flatten_with_names(params)) == list(named)
    rebuilt = tpytree.unflatten_from_names(params, back)
    assert list(tpytree.flatten_with_names(rebuilt)) == list(named)


def test_activations_stay_channels_last():
    spec = tresnet.model_spec("resnet50", image_size=64)
    module = spec.init_fn("cpu")
    seen = []
    for gn in module.modules():
        if isinstance(gn, tresnet.GroupNorm):
            gn.register_forward_pre_hook(
                lambda m, args: seen.append(args[0].is_contiguous(
                    memory_format=torch.channels_last)))
    with torch.inference_mode():
        module(torch.zeros(1, 64, 64, 3))
    assert len(seen) == 53 and all(seen)


def test_same_pads_follow_tf():
    assert tresnet._same_pads(56, 3, 2) == (0, 1)
    assert tresnet._same_pads(112, 3, 2) == (0, 1)
    assert tresnet._same_pads(112, 4, 1) == (1, 2)
    assert tresnet._same_pads(56, 3, 1) == (1, 1)
    assert tresnet._same_pads(56, 1, 2) == (0, 0)
