"""The port's MobileNetV2 (elasticdl_tpu_torch/models/mobilenet.py)
against the JAX package's at full width (2,236,682 parameters, 32x32x3,
batch 4) on the CPU.  The weights are the JAX ``init_fn(PRNGKey(0))``'s,
carried into the port through the weight map (``params_from_jax``:
conv kernels HWIO -> OIHW, the depthwise ``(3, 3, 1, C)`` ->
``(C, 1, 3, 3)`` among them, the Dense kernel transposed).

Tolerances, each beside the worst this file measured on the CPU:
 - logits 1e-4 absolute (measured 6.2e-6), float32 both sides;
 - per-example loss 1e-5 absolute (measured 6.0e-6), float32;
 - every gradient leaf 3e-5 absolute + 3e-4 relative, the GroupNorm
   gradient tolerance of tests/test_group_norm.py (measured worst 7e-4
   of the bound), float64 both sides;
 - parameters after one SGD-momentum step 1e-6 absolute (measured
   1.8e-9), float64 both sides;
 - the stride-2 SAME stem at 64x64 as the logits (measured 8.3e-6).

Why the gradients are compared in float64: this model's float32
gradients at init are ill-conditioned.  On three seeded batches each
package's own float32 gradients drift from its float64 ones, leaf by
leaf, to 0.056, 343 and 8.7 times the bound above (the port) and to
22 % of a leaf's largest entry (JAX, InvertedResidual_14/Conv_0/kernel
on the first batch), where the two float64 gradients agree to 0.0011 of
the bound (three batches).  So float32 against float32 tests rounding, not the port;
float64 tests the function and its gradient graph.  The port's
GroupNorm promotes to float64 for a float64 input, as flax's does.
"""

import math

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models import mobilenet
from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer

LR = 0.05
LOGITS_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 3e-4
STEP_ATOL = 1e-6
PARAM_COUNT = 2_236_682        # ftlib_benchmark.md:45, the JAX tree's


@pytest.fixture(scope="module")
def jax_model():
    """The JAX spec, its ``init_fn(PRNGKey(0))`` (jitted: the same numbers
    as the eager init in a fraction of its time) and the flat names."""
    import jax

    from elasticdl_tpu.models import mobilenet as jmobilenet
    from elasticdl_tpu.utils.pytree import flatten_with_names

    spec = jmobilenet.model_spec(learning_rate=LR)
    params = jax.jit(spec.init_fn)(jax.random.PRNGKey(0))
    named = {k: np.asarray(v)
             for k, v in flatten_with_names(params)[0].items()}
    return spec, params, named


def port_module(named, **kwargs):
    spec = mobilenet.model_spec(learning_rate=LR, **kwargs)
    module = spec.init_fn("cpu", 0)
    module.load_state_dict(spec.params_from_jax(named))
    return spec, module


def batch(n=4, size=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


def test_parameter_names_and_count_equal_the_jax_tree(jax_model):
    _, _, named = jax_model
    assert sum(v.size for v in named.values()) == PARAM_COUNT
    spec = mobilenet.model_spec()
    module = spec.init_fn("cpu", 0)
    assert sum(p.numel() for p in module.parameters()) == PARAM_COUNT
    ported = spec.params_to_jax(module)
    assert sorted(ported) == sorted(named)
    for name, value in named.items():
        assert ported[name].shape == value.shape, name
    # The depthwise kernel crosses the map as any conv kernel does.
    dw = "InvertedResidual_1/Conv_1/kernel"
    assert named[dw].shape == (3, 3, 1, 96)
    assert module.InvertedResidual_1.Conv_1.weight.shape == (96, 1, 3, 3)
    assert module.InvertedResidual_1.Conv_1.groups == 96
    # A fresh port model draws from flax's families: GroupNorm scale 1,
    # biases 0, so the zoo name and the first loss are the JAX model's.
    assert spec.name == "mobilenetv2"
    assert all(float(v.abs().max()) == 0 for k, v in
               module.state_dict().items() if k.endswith(".bias"))


def test_logits_and_per_example_loss_match_jax(jax_model):
    jspec, params, named = jax_model
    spec, module = port_module(named)
    xs, ys = batch()
    want = np.asarray(jspec.apply_fn(params, xs, True))
    got = module(torch.from_numpy(xs))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGITS_ATOL,
                               rtol=0)
    want_loss = np.asarray(jspec.loss_fn(want, ys))
    got_loss = spec.loss_fn(got, torch.from_numpy(ys))
    assert got_loss.shape == (4,) and got_loss.dtype == torch.float32
    np.testing.assert_allclose(got_loss.detach().numpy(), want_loss,
                               atol=LOSS_ATOL, rtol=0)


def jax_float64_step(jspec, params, xs, ys):
    """The JAX model's gradients of the mean loss, and the parameters
    after one ``optax.sgd(LR, momentum=0.9)`` step, in float64
    (``jax.enable_x64``) from the same float32 weights: the reference
    the port's float32 is held to (module docstring)."""
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu.utils.pytree import flatten_with_names

    def named(tree):
        return {k: np.asarray(v)
                for k, v in flatten_with_names(tree)[0].items()}

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        x64 = jnp.asarray(xs, jnp.float64)

        def loss(p):
            return jspec.loss_fn(jspec.apply_fn(p, x64, True), ys).mean()

        grads = jax.jit(jax.grad(loss))(p64)
        opt = optax.sgd(LR, momentum=0.9)
        updates, _ = opt.update(grads, opt.init(p64), p64)
        return named(grads), named(optax.apply_updates(p64, updates))


def test_every_gradient_leaf_matches_jax(jax_model):
    jspec, params, named = jax_model
    spec, module = port_module(named)
    module.double()
    xs, ys = batch(seed=1)
    want, _ = jax_float64_step(jspec, params, xs, ys)
    spec.loss_fn(module(torch.from_numpy(xs).double()),
                 torch.from_numpy(ys)).mean().backward()
    got = {jax_name(name): spec.to_jax_layout(p.grad)
           for name, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float64
        np.testing.assert_allclose(got[name], want[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
        assert np.abs(want[name]).max() > 0, name   # every leaf learns


def test_one_sgd_momentum_step_matches_optax(jax_model):
    """One step through the port's CollectiveTrainer (its module in
    float64, module docstring) against optax.sgd (momentum 0.9) on the
    JAX float64 gradients of the same batch."""
    jspec, params, named = jax_model
    xs, ys = batch(seed=2)
    _, want = jax_float64_step(jspec, params, xs, ys)
    spec = mobilenet.model_spec(learning_rate=LR)
    trainer = CollectiveTrainer(spec, batch_size=4, device="cpu")
    trainer.module.double()
    trainer.set_params(spec.params_from_jax(named))
    loss, version = trainer.train_minibatch(xs.astype(np.float64), ys)
    assert version == 1 and math.isfinite(float(loss))
    got = trainer.export_parameters()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=STEP_ATOL,
                                   rtol=0, err_msg=name)


def test_group_norm_is_flax_fast_variance_not_two_pass():
    """A large mean (1e3 + integer noise in [-1, 1]): flax's variance is
    E[x^2] - E[x]^2 in float32, which cancels at 1e6 (a float32 step of
    0.0625), where a two-pass variance does not.  In groups of 8 integers
    every sum is exact in float32 in any order, so the formula is the
    only difference: the port is within 2.4e-7 of flax, the two-pass
    number (flax's eps) 1.1e-4 away, torch's defaults (eps 1e-5) as far.
    (In groups of thousands of elements the fast variance's cancellation
    error depends on the reduction order, which XLA's CPU reduction and
    torch's do not share: there both are noise, ~4e3 apart at a mean of
    1e3 and unit variance.)"""
    import flax.linen as fnn
    import jax

    rng = np.random.RandomState(0)
    x = (1e3 + rng.randint(-1, 2, size=(4, 2, 2, 16))).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=8)
    variables = gn.init(jax.random.PRNGKey(0), x)
    want = np.asarray(gn.apply(variables, x))
    got = mobilenet.GroupNorm(16, 8)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = got.detach().numpy()
    two_pass = torch.nn.functional.group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 8,
        eps=mobilenet.EPSILON).permute(0, 2, 3, 1).numpy()
    torch_default = torch.nn.GroupNorm(8, 16)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # The case tells the formulas apart: the two-pass number (flax's eps)
    # and torch's defaults (1e-5, two-pass) are far from flax's.
    assert np.abs(two_pass - want).max() > 2e-5
    assert np.abs(torch_default.detach().numpy() - want).max() > 2e-5


def test_stride_two_same_stem_at_64(jax_model):
    """``cifar_stem=False``: the stem's 3x3/2 SAME conv pads (0, 1) on
    64 -> 32, as every stride-2 depthwise conv does; the same parameter
    tree, another stem stride."""
    import jax

    from elasticdl_tpu.models import mobilenet as jmobilenet

    _, params, named = jax_model
    jspec = jmobilenet.model_spec(image_size=64, cifar_stem=False)
    xs, _ = batch(n=2, size=64, seed=4)
    want = np.asarray(jax.jit(
        lambda p, x: jspec.apply_fn(p, x, True))(params, xs))
    _, module = port_module(named, image_size=64, cifar_stem=False)
    got = module(torch.from_numpy(xs)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    # Symmetric padding (torch's padding=1) would sample other pixels.
    stem = module.Conv_0
    x = torch.from_numpy(xs).permute(0, 3, 1, 2)
    with torch.no_grad():
        sym = torch.nn.functional.conv2d(x, stem.weight, stride=2,
                                         padding=1)
        same = stem(x.contiguous(memory_format=torch.channels_last))
    assert sym.shape == same.shape and sym.shape[-1] == 32
    assert float((sym - same).abs().max()) > 1e-2
