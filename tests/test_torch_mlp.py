"""The port's shared MLP (elasticdl_tpu_torch/models/mlp.py) against the
JAX package's (elasticdl_tpu/models/mlp.py) on the CPU.

``mlp_apply`` on the JAX ``mlp_init`` parameters, carried through the
port's dense layout map (``spec.from_jax_layout``), equals the JAX
``mlp_apply`` within 1e-5 absolute (float32 matmuls in other orders;
measured 2.1e-7).  ``mlp_init`` keeps the reference's names and shapes,
zero biases, and He-normal weights: the sample std of each kernel of
a wider stack is within 5 % of sqrt(2 / fan_in).
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import mlp as jmlp
from elasticdl_tpu_torch.models import mlp
from elasticdl_tpu_torch.models.spec import from_jax_layout, to_jax_layout

SIZES = [16, 128, 64, 1]
STAT_SIZES = [256, 512, 64]
ATOL = 1e-5


def test_apply_on_carried_parameters_matches_jax():
    params = jmlp.mlp_init(jax.random.PRNGKey(0), SIZES)
    x = np.random.RandomState(0).randn(32, SIZES[0]).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply(params, x))
    ported = {k: from_jax_layout(np.asarray(v)) for k, v in params.items()}
    got = mlp.mlp_apply(ported, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (32, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # And back: the port's tree in the JAX layout runs in the JAX mlp.
    back = {k: to_jax_layout(v) for k, v in ported.items()}
    np.testing.assert_allclose(np.asarray(jmlp.mlp_apply(back, x)), got,
                               atol=ATOL, rtol=0)


def test_init_names_shapes_zero_biases_and_he_std():
    gen = torch.Generator().manual_seed(0)
    params = mlp.mlp_init(SIZES, gen)
    want = jmlp.mlp_init(jax.random.PRNGKey(0), SIZES)
    assert sorted(params) == sorted(want)
    for name, value in params.items():
        assert to_jax_layout(value).shape == want[name].shape, name
        assert value.dtype == torch.float32
        if name.startswith("b"):
            assert float(value.abs().max()) == 0.0, name
    # He std as a statistic, on kernels of 32,768+ samples (a relative
    # spread of 0.4 %: the 5 % bound is 12 of them).
    big = mlp.mlp_init(STAT_SIZES, gen)
    for i, fan_in in enumerate(STAT_SIZES[:-1]):
        w = big["w%d" % i]
        std = (2.0 / fan_in) ** 0.5
        assert abs(float(w.mean())) < 5 * std / w.numel() ** 0.5
        assert float(w.std()) == pytest.approx(std, rel=0.05)
    # The generator decides the draw: another seed, other numbers.
    other = mlp.mlp_init(SIZES, torch.Generator().manual_seed(1))
    assert not torch.equal(other["w0"], params["w0"])
    again = mlp.mlp_init(SIZES, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_extra_keys_are_ignored():
    params = mlp.mlp_init(SIZES, torch.Generator().manual_seed(2))
    x = torch.from_numpy(
        np.random.RandomState(1).randn(8, SIZES[0]).astype(np.float32))
    want = mlp.mlp_apply(params, x)
    mixed = dict(params, bias=torch.full((1,), 3.0), emb=torch.ones(4, 2))
    torch.testing.assert_close(mlp.mlp_apply(mixed, x), want, rtol=0,
                               atol=0)
    # The JAX mlp ignores the same extra key.
    jparams = {k: to_jax_layout(v) for k, v in params.items()}
    jparams["bias"] = np.full((1,), 3.0, np.float32)
    np.testing.assert_allclose(np.asarray(jmlp.mlp_apply(jparams, x.numpy())),
                               want.numpy(), atol=ATOL, rtol=0)
