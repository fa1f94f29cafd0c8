"""The port's partial attention (``flash_attention_partial``, its Function
and ``_partial_stats_bwd``, ``_partial_banded``;
elasticdl_tpu_torch/ops/flash_attention.py) against the JAX package's on
the CPU, where the JAX partial runs its Pallas kernel (B3p,
``normalize=False``) in interpret mode and the port's wrapper takes its
plain version ``_partial_ref``.

Inputs and cotangents are made with numpy from a seed and fed to both
packages.  Tolerances are the reference tests' own: 2e-5 abs/rel on acc,
l and m (tests/test_flash_attention.py's forward tolerance; sums in other
orders), 1e-4 abs/rel on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def qkv(t, seed, b=1, h=2, d=64, tied=False):
    q, k, v = arrays([(b, h, t, d)] * 3, seed)
    if tied:
        # Keys in equal pairs: each row's max score is taken at least
        # twice where the mask keeps both keys of its pair.
        k[:, :, 1::2] = k[:, :, 0::2]
    return q, k, v


def cotangents(t, seed, b=1, h=2, d=64):
    return arrays([(b, h, t, d), (b, h, t), (b, h, t)], seed)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def torch_leaves(arrs):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64), (True, 200)])
def test_partial_matches_the_jax_kernel(t, causal, window):
    """acc, l and m of the port's partial against the JAX B3p in interpret
    mode (T=128: one 128-row block; 256: two)."""
    q, k, v = qkv(t, seed=t + window)
    want = jfa.flash_attention_partial(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        interpret=True, window=window)
    got = tfa.flash_attention_partial(*(torch.from_numpy(a) for a in
                                        (q, k, v)), causal=causal,
                                      window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g, w, FWD_TOL)


@pytest.mark.parametrize("k_offset,window", [(-128, 0), (-128, 200),
                                             (64, 0)])
def test_offset_route_is_the_plain_version(k_offset, window):
    """A causal block with a k offset goes to ``_partial_ref`` in both
    packages, with its gradients by autograd."""
    q, k, v = qkv(128, seed=3)
    ga, gl, gm = cotangents(128, seed=4)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_partial(
        q, k, v, causal=True, k_offset=k_offset, interpret=True,
        window=window), jq, jk, jv)
    leaves = torch_leaves((q, k, v))
    got = tfa.flash_attention_partial(*leaves, causal=True,
                                      k_offset=k_offset, window=window)
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in
                                  (ga, gl, gm)])
    for leaf, w in zip(leaves, vjp((jnp.asarray(ga), jnp.asarray(gl),
                                    jnp.asarray(gm)))):
        close(leaf.grad, w, GRAD_TOL)


@pytest.mark.parametrize("t", [128, 256, 384])
@pytest.mark.parametrize("causal,window,tied", [
    (True, 0, False), (False, 0, False), (True, 0, True), (False, 0, True),
    (True, 100, False)])
def test_partial_gradients_match_jax_grad(t, causal, window, tied):
    """The Function's gradients with all three cotangents (acc, l, m)
    against ``jax.vjp`` through the JAX custom_vjp: ``_partial_stats_bwd``
    where K splits into two or more 128-key blocks (T=256, 384), the
    autograd of ``_partial_ref`` where it does not (T=128).  ``tied``
    rows take their max at two keys: both backwards split the m
    cotangent between them, as the gradient of a max does."""
    q, k, v = qkv(t, seed=11, tied=tied)
    cot = cotangents(t, seed=12)
    want, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_partial(
        q, k, v, causal=causal, interpret=True, window=window),
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = torch_leaves((q, k, v))
    got = tfa.flash_attention_partial(*leaves, causal=causal, window=window)
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cot])
    for leaf, w in zip(leaves, vjp(tuple(jnp.asarray(c) for c in cot))):
        close(leaf.grad, w, GRAD_TOL)


def test_stats_bwd_splits_ties_as_the_dense_gradient():
    """``_partial_stats_bwd`` against autograd through ``_partial_ref`` in
    the port itself, on rows whose max is tied (the m cotangent alone
    reaches q and k only through the tie split)."""
    q, k, v = qkv(256, seed=21, tied=True)
    _, _, gm = cotangents(256, seed=22)
    zeros = [np.zeros_like(a) for a in cotangents(256, seed=22)[:2]]
    scale = 64 ** -0.5
    for causal in (True, False):
        leaves = torch_leaves((q, k, v))
        outs = tfa._partial_ref(*leaves, causal, scale, 0)
        torch.autograd.backward(outs, [torch.from_numpy(c) for c in
                                       zeros + [gm]])
        acc, l, _ = (o.detach() for o in outs)
        got = tfa._partial_stats_bwd(
            *(torch.from_numpy(a) for a in (q, k, v)), acc, l,
            *(torch.from_numpy(c) for c in zeros + [gm]), causal, scale, 0,
            128)
        for g, leaf in zip(got, leaves):
            close(g, leaf.grad.numpy(), GRAD_TOL)


@pytest.mark.parametrize("tk,k_offset,window", [
    (256, -256, 300), (256, -256, 400), (384, -384, 500), (128, -128, 200)])
def test_partial_banded_matches_jax(tk, k_offset, window):
    """``_partial_banded`` (the ring's window-straddling block) against the
    JAX function: forward and gradients with all three cotangents.  Tk=128
    is one block, the plain version's route in both."""
    q, k, v = qkv(tk, seed=31)
    cot = cotangents(tk, seed=32)
    scale = 64 ** -0.5
    want, vjp = jax.vjp(lambda q, k, v: jfa._partial_banded(
        q, k, v, scale, k_offset, window),
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = torch_leaves((q, k, v))
    got = tfa._partial_banded(*leaves, scale, k_offset, window)
    for g, w in zip(got, want):
        close(g, w, FWD_TOL)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cot])
    for leaf, w in zip(leaves, vjp(tuple(jnp.asarray(c) for c in cot))):
        close(leaf.grad, w, GRAD_TOL)


def test_partial_counts_no_launch_on_the_cpu():
    """On the CPU the wrapper takes the plain version: no kernel launch is
    counted, and the forward is ``_partial_ref`` bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in qkv(64, seed=41))
    before = (tfa.LAUNCHES, tfa.PARTIAL_LAUNCHES)
    got = tfa.flash_partial_forward(q, k, v, causal=True)
    assert (tfa.LAUNCHES, tfa.PARTIAL_LAUNCHES) == before
    for g, w in zip(got, tfa._partial_ref(q, k, v, True, 64 ** -0.5, 0)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention_partial(q, k, v, causal=False, window=8)
