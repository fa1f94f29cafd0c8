"""The port's flash attention backward (``flash_backward``, its plain
version ``_flash_bwd_ref`` and the autograd Function behind
``flash_attention``; elasticdl_tpu_torch/ops/flash_attention.py) against
the JAX package's on the CPU, where the JAX backward kernel pair
``_pallas_bwd`` runs in Pallas interpret mode.

Inputs and cotangents are made with numpy from a seed and fed to both
packages.  Tolerances:
 - 1e-3 abs/rel through ``jax.grad`` of the JAX ``flash_attention``, the
   oracle's own (tests/test_flash_attention.py's
   ``test_pallas_bwd_matches_reference``): the two forwards' residuals
   differ by their own rounding;
 - float32 1e-4 abs/rel against ``_pallas_bwd`` called on the same
   residuals and g: the same arithmetic, sums taken in other orders;
 - bfloat16 2e-2 abs/rel against ``_pallas_bwd``: both round ds and p to
   bf16, and an element near a rounding boundary may land one bf16 ulp
   apart, as may the outputs' own rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.parallel import ring_attention as jring
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.parallel import ring_attention as tring

GRAD_TOL = 1e-3
SAME_RES_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WINDOWS = [64, 200, 1000]    # as tests/test_window_attention.py at t=384


def arrays(shape, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def to_jax(a, dtype="float32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def to_torch(a, dtype="float32", grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return t.requires_grad_() if grad else t


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture
def pallas_bwd_spy(monkeypatch):
    """Records that the JAX custom_vjp took the Pallas backward pair."""
    called = []
    orig = jfa._pallas_bwd

    def spy(*args, **kwargs):
        called.append(True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa, "_pallas_bwd", spy)
    return called


def jax_grads(q, k, v, g, causal, window=0):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                  window=window)
        return (out * g).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def port_grads(q, k, v, g, causal, window=0):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(q, k, v, causal=causal, window=window).backward(g)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [256, 384])
def test_grads_match_jax_pallas_backward(causal, t, pallas_bwd_spy):
    """t=384 gives the JAX pair a 3x3 grid of 128-row tiles (their carry
    across the streamed axis and the dead-block clamps engage)."""
    q, k, v, g = arrays((1, 2, t, 64), 4, seed=t + causal)
    want = jax_grads(*map(to_jax, (q, k, v, g)), causal)
    assert pallas_bwd_spy, "the JAX backward did not take _pallas_bwd"
    got = port_grads(*map(to_torch, (q, k, v, g)), causal)
    for a, b in zip(got, want):
        close(a, b, GRAD_TOL)


@pytest.mark.parametrize("window", WINDOWS)
def test_window_grads_match_jax(window, pallas_bwd_spy):
    q, k, v, g = arrays((1, 2, 384, 64), 4, seed=window)
    want = jax_grads(*map(to_jax, (q, k, v, g)), True, window)
    assert pallas_bwd_spy
    got = port_grads(*map(to_torch, (q, k, v, g)), True, window)
    for a, b in zip(got, want):
        close(a, b, GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 200)])
def test_flash_backward_matches_pallas_bwd_on_equal_residuals(
        dtype, causal, window):
    """``flash_backward`` and ``_pallas_bwd`` on the residuals of the JAX
    forward kernel and the same g: the plain version repeats the pair's
    arithmetic, roundings included."""
    q, k, v, g = arrays((1, 2, 384, 64), 4, seed=11)
    jq, jk, jv, jg = (to_jax(a, dtype) for a in (q, k, v, g))
    scale = 64 ** -0.5
    out, l, m = jfa._flash_forward(jq, jk, jv, causal, scale, 128, 128,
                                   True, window=window)
    want = jfa._pallas_bwd(jq, jk, jv, out, l, m, jg, causal, scale, True,
                           window=window)
    got = tfa.flash_backward(
        *(to_torch(a, dtype) for a in (q, k, v, out)), to_torch(l),
        to_torch(m), to_torch(g, dtype), causal=causal, window=window)
    for a, b, src in zip(got, want, (jq, jk, jv)):
        assert a.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
        assert a.shape == src.shape
        close(a, b, SAME_RES_TOL[dtype])


def test_ring_layout_grads_match_jax_attention_local(pallas_bwd_spy):
    """[B, T, H, D] in, through the JAX kernel pair in interpret mode on
    one side and the port's ``ring_attention`` (transposed views into the
    Function) on the other."""
    q, k, v, g = arrays((2, 128, 2, 64), 4, seed=3)
    for window in (0, 40):
        def loss(q, k, v):
            out = jring.attention_local(q, k, v, causal=True,
                                        mode="interpret", window=window)
            return (out * to_jax(g)).sum()

        want = jax.grad(loss, argnums=(0, 1, 2))(
            *map(to_jax, (q, k, v)))
        tq, tk, tv = (to_torch(a, grad=True) for a in (q, k, v))
        tring.ring_attention(tq, tk, tv, None, causal=True,
                             window=window).backward(to_torch(g))
        for a, b in zip((tq.grad, tk.grad, tv.grad), want):
            assert a.shape == (2, 128, 2, 64)
            close(a, b, GRAD_TOL)
    assert pallas_bwd_spy


@pytest.mark.parametrize("t,causal", [(200, True), (77, False)])
def test_ragged_t_grads_match_jax_reference(t, causal):
    """A T the JAX kernels do not take: the port runs its plain backward
    all the same, and matches ``jax.grad`` of ``_attention_ref``."""
    q, k, v, g = arrays((1, 2, t, 64), 4, seed=t)
    scale = 64 ** -0.5

    def loss(q, k, v):
        return (jfa._attention_ref(q, k, v, causal, scale) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(to_jax, (q, k, v)))
    got = port_grads(*map(to_torch, (q, k, v, g)), causal)
    for a, b in zip(got, want):
        close(a, b, GRAD_TOL)


def test_function_saves_the_custom_vjp_residuals():
    """The Function saves exactly (q, k, v, out, l, m), and its backward
    is ``flash_backward`` on them: the plain path and ``flash_backward``
    agree bit for bit on the CPU."""
    q, k, v, g = (to_torch(a) for a in arrays((1, 2, 128, 64), 4, seed=5))
    q.requires_grad_()
    out = tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    ref_out, l, m = tfa.flash_forward(q.detach(), k, v)
    assert len(saved) == 6
    for a, b in zip(saved, (q, k, v, ref_out, l, m)):
        assert torch.equal(a, b)
    out.backward(g)
    dq = tfa.flash_backward(q.detach(), k, v, ref_out, l, m, g)[0]
    assert torch.equal(q.grad, dq)
    # The plain path on any device is the same Function.
    q2 = q.detach().requires_grad_()
    tfa.flash_attention_ref(q2, k, v).backward(g)
    assert torch.equal(q2.grad, dq)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_backward(q.detach(), k, v, ref_out, l, m, g,
                           causal=False, window=8)


def _backward_sources():
    """The backward's CUDA source and the headers it includes, comments
    stripped: {file name: code}."""
    import os
    import re

    from elasticdl_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, "flash_attention_bwd.cu")) as f:
        main = f.read()
    names = ["flash_attention_bwd.cu"] + re.findall(
        r'#include "([^"]+)"', main)
    code = {}
    for name in names:
        with open(os.path.join(build.CSRC, name)) as f:
            text = f.read()
        text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
        code[name] = re.sub(r"//[^\n]*", "", text)
    return code


def test_backward_source_has_no_atomics():
    """B4 and B5 are deterministic by construction: no atomic operation
    (CUDA's atomic* functions, PTX atom.* or red.*) in their source or the
    headers it includes."""
    import re

    code = _backward_sources()
    assert set(code) >= {"flash_attention_bwd.cu", "flash_common.cuh",
                         "hopper.cuh"}
    for name, text in code.items():
        assert not re.search(r"atomic|\batom\.|\bred\.", text, re.I), name


def test_flagship_backward_dispatches_to_the_wgmma_kernels():
    """bf16 at head_dim 64 (the flagship LM's attention) reaches the
    kernels built on wgmma and TMA; head_dim 128 keeps the mma.sync pair."""
    import re

    code = _backward_sources()
    body = code["flash_attention_bwd.cu"]
    for which in ("dq", "dkv"):
        entry = body[body.index("int edl_flash_attention_bwd_%s(" % which):]
        bf16 = entry[entry.index("if (dtype == 1) {"):]
        assert re.match(
            r"if \(dtype == 1\) \{\s*if \(D == 64\)\s*return launch_hop\("
            r"bwd_%s_wgmma," % which, bf16), which
        assert "bwd_%s_bf16<128" % which in bf16[:bf16.index("}")]
    hopper = code["hopper.cuh"]
    assert "wgmma.mma_async" in hopper
    assert "cp.async.bulk.tensor" in hopper


def test_bwd_scratch_holds_four_floats_per_row():
    q = torch.zeros((2, 3, 5, 64), dtype=torch.bfloat16)
    scratch = tfa._bwd_scratch(q)
    assert scratch.shape == (2, 3, 5, 4)
    assert scratch.dtype == torch.float32 and scratch.is_contiguous()


def test_sweep_variants_apply_to_the_committed_sources():
    """Every variant and ablation of scripts/sweep_flash_attention.py is a
    set of substitutions whose patterns must occur in the committed
    kernel source; a stale one would only show as a failed call on the
    card."""
    import os
    import sys

    from elasticdl_tpu_torch.ops import build

    sys.path.insert(0, os.path.join(os.path.dirname(build.CSRC), "..", "..",
                                    "scripts"))
    try:
        import sweep_flash_attention as sweep
    finally:
        sys.path.pop(0)
    tables = []
    for source, variants, *_, ablations in sweep.MODES.values():
        tables += [(source, variants), (source, ablations)]
    for source, variants in tables:
        with open(os.path.join(build.CSRC, source + ".cu")) as f:
            text = f.read()
        for name, subs in variants.items():
            changed = sweep.variant_source(text, subs)
            assert (changed == text) == (not subs), (source, name)
