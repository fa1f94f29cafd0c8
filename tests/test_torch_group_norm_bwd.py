"""The port's GroupNorm backward (``_FusedGroupNorm`` through
``fused_group_norm``, and ``_bwd_ref``, the plain version of the
backward kernel) against the JAX package's fused kernel in Pallas
interpret mode, from the same numpy-seeded inputs.

Tolerances: float32 3e-5 abs / 3e-4 rel, the JAX package's own gradient
tolerance (tests/test_group_norm.py); bfloat16 3e-2 (dx is rounded to
bf16 on both sides, one bf16 ulp is 2^-8 relative, and the two sides
round x-hat from different f32 statistics); the large-mean case against
float64 autograd at 1e-2 of the largest entry, as the JAX package holds
its forward on that input (a float32 mean of 3000 carries an error of
order 1e-4, against a standard deviation of 0.1).

The CUDA kernel itself runs only on the card (test_torch_group_norm_cuda
and chip_smoke.py hold it against ``_bwd_ref``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import group_norm as jgn
from elasticdl_tpu_torch.ops import group_norm as tgn

SHAPES = [
    ((2, 8, 8, 64), 32),
    ((3, 4, 4, 16), 8),
    ((2, 16, 32), 4),          # rank-3 input
    ((2, 6, 6, 8), 4),         # C/G = 2, HW not a power of two
]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("ELASTICDL_FUSED_GN", "interpret")


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, w


def _jax_grads(x, scale, bias, w, groups, relu, dtype=jnp.float32):
    def loss(x, s, b):
        y = jgn.fused_group_norm(x, s, b, groups, relu=relu)
        return jnp.sum(y.astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(x, scale, bias, w, groups, relu, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype).requires_grad_(),
         torch.from_numpy(scale).requires_grad_(),
         torch.from_numpy(bias).requires_grad_()]
    y = tgn.fused_group_norm(*t, groups, relu=relu)
    assert y.grad_fn is not None
    (y.float() * torch.from_numpy(w)).sum().backward()
    assert t[0].grad.dtype == dtype
    assert t[1].grad.dtype == t[2].grad.dtype == torch.float32
    return [a.grad.float().numpy() for a in t]


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_gradients_match_jax(shape, groups, relu):
    x, scale, bias, w = _inputs(shape)
    want = _jax_grads(x, scale, bias, w, groups, relu)
    got = _port_grads(x, scale, bias, w, groups, relu)
    for name, g, e in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(g, e, atol=3e-5, rtol=3e-4, err_msg=name)


@pytest.mark.parametrize("relu", [False, True])
def test_bwd_ref_matches_bwd_pallas(relu):
    # The kernel contract, at C = 128 (no lane folding on the TPU side):
    # the same x, dy and forward statistics into both backward kernels.
    x, scale, bias, dy = _inputs((2, 16, 128), seed=1)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    _, mean, rstd = jgn._fwd_pallas(jx, js, jb, 32, 1e-6, relu, True)
    want = jgn._bwd_pallas(jx, jnp.asarray(dy), js, jb, mean, rstd, 32,
                           1e-6, relu, True)
    got = tgn._bwd_ref(
        *[torch.from_numpy(a) for a in (x, dy, scale, bias)],
        torch.from_numpy(np.array(mean)),
        torch.from_numpy(np.array(rstd)), 32, 1e-6, relu)
    assert got[0].shape == (2, 16, 128) and got[1].shape == (128,)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=3e-5,
                                   rtol=3e-4)


@pytest.mark.parametrize("relu", [False, True])
def test_bf16_gradients_match_jax(relu):
    x, scale, bias, w = _inputs((2, 4, 4, 32), seed=2)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = _jax_grads(x, scale, bias, w, 8, relu, dtype=jnp.bfloat16)
    got = _port_grads(x, scale, bias, w, 8, relu, dtype=torch.bfloat16)
    for name, g, e in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(g, e, atol=3e-2, rtol=3e-2, err_msg=name)


def test_large_mean_gradients():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 8, 8, 32) * 0.1 + 3000.0).astype(np.float32)
    scale = (rng.rand(32) + 0.5).astype(np.float32)
    bias = (rng.randn(32) * 0.1).astype(np.float32)
    w = rng.randn(2, 8, 8, 32).astype(np.float32)

    x64 = torch.from_numpy(x).double().requires_grad_()
    s64 = torch.from_numpy(scale).double().requires_grad_()
    b64 = torch.from_numpy(bias).double().requires_grad_()
    xr = x64.reshape(2, -1, 8, 4)
    m = xr.mean(dim=(1, 3), keepdim=True)
    v = ((xr - m) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xr - m) / torch.sqrt(v + 1e-6)).reshape(x64.shape) * s64 + b64
    (torch.relu(y) * torch.from_numpy(w).double()).sum().backward()
    truth = [t.grad.numpy() for t in (x64, s64, b64)]

    got = _port_grads(x, scale, bias, w, 8, relu=True)
    for name, g, e in zip(("dx", "dscale", "dbias"), got, truth):
        np.testing.assert_allclose(g, e, rtol=0,
                                   atol=1e-2 * np.abs(e).max(),
                                   err_msg=name)


def test_grad_mode_decides_the_path():
    x, scale, bias, _ = _inputs((2, 4, 4, 32), seed=3)
    t = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    with torch.inference_mode():
        y = tgn.fused_group_norm(*t, 8, relu=True)
    assert y.grad_fn is None
    y2 = tgn.fused_group_norm(*t, 8, relu=True)
    assert type(y2.grad_fn).__name__ == "_FusedGroupNormBackward"
    np.testing.assert_array_equal(y.numpy(), y2.detach().numpy())
    assert tgn.BWD_LAUNCHES == tgn.LAUNCHES == 0   # CPU: plain versions
