"""The port's GroupNorm (elasticdl_tpu_torch/ops/group_norm.py) against
the JAX package's fused kernel in Pallas interpret mode, from the same
numpy-seeded inputs.

Tolerances: float32 2e-5 abs/rel (the JAX package's own forward
tolerance; both sides reduce in f32 in different orders); bfloat16
3e-2 (one bf16 rounding of the output, 2^-8 relative, on values of
order 1-3); the large-mean case against float64 numpy at 1e-2, as
tests/test_group_norm.py holds the JAX kernel.

The CUDA kernel itself runs only on the card: its tests are in
test_torch_group_norm_cuda.py, and chip_smoke.py holds it at every
ResNet-50 shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import group_norm as jgn
from elasticdl_tpu_torch.ops import group_norm as tgn


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("ELASTICDL_FUSED_GN", "interpret")


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    return x, scale, bias


def _jax(x, scale, bias, groups, relu, dtype=jnp.float32):
    y = jgn.fused_group_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                             jnp.asarray(bias), groups, relu=relu)
    return np.asarray(y.astype(jnp.float32))


SHAPES = [
    ((2, 8, 8, 64), 32),
    ((3, 4, 4, 16), 8),
    ((2, 16, 32), 4),          # rank-3 input
    ((2, 6, 6, 8), 4),         # C/G = 2, HW not a power of two
]


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_forward_matches_jax(shape, groups, relu):
    x, scale, bias = _inputs(shape)
    want = _jax(x, scale, bias, groups, relu)
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = tgn.fused_group_norm(*t, groups, relu=relu)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    plain = tgn._group_norm_ref(*t, groups, 1e-6, relu)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_stats_match_pallas_forward(relu):
    # The kernel contract: y plus f32 per-channel mean and rstd [B, 1, C]
    # (C = 128, so the TPU kernel's lane folding leaves them unfolded).
    x, scale, bias = _inputs((2, 16, 128), seed=1)
    want_y, want_mean, want_rstd = jgn._fwd_pallas(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6,
        relu, True)
    y, mean, rstd = tgn.group_norm_fwd(
        *[torch.from_numpy(a) for a in (x, scale, bias)], 32, relu=relu)
    assert mean.shape == rstd.shape == (2, 1, 128)
    assert mean.dtype == rstd.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_bf16_matches_jax(relu):
    x, scale, bias = _inputs((2, 4, 4, 32), seed=2)
    want = _jax(x, scale, bias, 8, relu, dtype=jnp.bfloat16)
    got = tgn.fused_group_norm(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias), 8, relu=relu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=3e-2, rtol=3e-2)


def test_large_mean_variance_stability():
    # mean 1e4, std 1: E[x^2]-E[x]^2 would lose every digit of the
    # variance in f32; the oracle is float64 numpy.
    rng = np.random.RandomState(5)
    x64 = rng.randn(2, 8, 8, 32) + 1e4
    xr = x64.reshape(2, -1, 8, 4)
    m = xr.mean(axis=(1, 3), keepdims=True)
    v = ((xr - m) ** 2).mean(axis=(1, 3), keepdims=True)
    truth = ((xr - m) / np.sqrt(v + 1e-6)).reshape(x64.shape)
    ones, zeros = np.ones(32, np.float32), np.zeros(32, np.float32)
    got = tgn.fused_group_norm(
        torch.from_numpy(x64.astype(np.float32)), torch.from_numpy(ones),
        torch.from_numpy(zeros), 8)
    np.testing.assert_allclose(got.numpy(), truth, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(
        _jax(x64.astype(np.float32), ones, zeros, 8, False), truth,
        atol=1e-2, rtol=1e-2)


def test_groups_must_divide_channels():
    x, scale, bias = _inputs((2, 4, 4, 12))
    with pytest.raises(ValueError, match="not divisible"):
        tgn.fused_group_norm(
            *[torch.from_numpy(a) for a in (x, scale, bias)], 8)


def test_cpu_never_counts_launches():
    before = tgn.LAUNCHES
    x, scale, bias = _inputs((2, 4, 4, 32))
    tgn.fused_group_norm(*[torch.from_numpy(a) for a in (x, scale, bias)],
                         8, relu=True)
    assert tgn.LAUNCHES == before == 0

