"""The port's remat policies (elasticdl_tpu_torch/models/transformer.py:
``remat`` False, True, "dots" and "attn") against the JAX package's on
the CPU, dense and mixture-of-experts.

- Gradients: each policy's against the port's remat=False (1e-5
  relative + 1e-7 absolute: the same float32 arithmetic, recomputed) and
  against the JAX package's gradients under the same policy (1e-4
  relative + 1e-5 absolute, its remat gradient tolerance).
- Recomputation: the attention kernels a training step runs, against the
  ``pallas_call`` equations of the JAX ``jax.grad`` program under the
  same policy with ``ELASTICDL_FLASH=interpret`` (scan bodies counted by
  their length, remat bodies entered): B3 (three outputs: out, l, m) once
  per layer without remat and twice under every policy, B4 (dq) and B5
  (dk, dv) once each.  On the CPU the port's wrappers take their plain
  versions and launch nothing, so the test counts the calls that launch
  the kernels on the card into the same counters (``LAUNCHES``,
  ``BWD_DQ_LAUNCHES``, ``BWD_DKV_LAUNCHES``): each ``flash_forward`` call
  is one B3 launch on a CUDA tensor, each ``flash_backward`` one B4 and
  one B5.
- What each policy keeps: the aten ops the backward runs.  "dots" runs
  no weight product (``mm``) of the forward again but recomputes the
  batched ones (``bmm``); "attn" runs the named attention output again
  never and every weight product again, as remat=True does.
"""

import collections
import dataclasses

import jax
import jax.extend.core
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.ops import flash_attention as tfa

POLICIES = [True, "dots", "attn"]
VARIANTS = {"dense": {}, "moe": {"moe_experts": 4},
            "moe_gqa_window": {"moe_experts": 4, "num_kv_heads": 2,
                               "window": 8}}
SMALL = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
             max_seq_len=32, dtype="float32")
# The flash kernels' shapes: head_dim 64 and T = 128, the Pallas block.
KERNEL = dict(vocab_size=128, dim=128, num_heads=2, num_layers=2,
              max_seq_len=128, dtype="float32")


def named(tree):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree)[0].items()}


def build(base, seed=7, **overrides):
    kw = dict(base, **overrides)
    jcfg, tcfg = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    module = ttfm.TransformerLM(tcfg)
    module.load_state_dict(ttfm.params_from_jax(named(jparams)))
    return jcfg, jparams, tcfg, module


def tokens(b, t, seed):
    return np.random.RandomState(seed).randint(0, 128, size=(b, t)
                                               ).astype(np.int32)


def jax_loss(cfg, toks):
    def loss(p):
        logits, aux = jtfm.forward(p, toks, cfg, return_aux=True)
        return (jtfm.next_token_loss(logits, toks).mean()
                + cfg.moe_aux_weight * aux)
    return loss


def port_loss(module, toks, cfg):
    logits, aux = ttfm.forward(module, torch.from_numpy(toks), cfg,
                               return_aux=True)
    return ttfm.next_token_loss(logits, torch.from_numpy(toks)).mean() + (
        cfg.moe_aux_weight * aux)


def port_grads(module, toks, cfg):
    module.zero_grad(set_to_none=True)
    loss = port_loss(module, toks, cfg)
    loss.backward()
    return float(loss.detach()), {
        name.replace(".", "/"): p.grad.clone().numpy()
        for name, p in module.named_parameters()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("remat", POLICIES, ids=str)
def test_policy_grads_match_no_remat_and_jax(remat, variant):
    jcfg, jparams, tcfg, module = build(SMALL, **VARIANTS[variant])
    toks = tokens(2, 16, seed=4)
    loss0, grads0 = port_grads(module, toks, tcfg)
    tcfg_r = dataclasses.replace(tcfg, remat=remat)
    loss_r, grads_r = port_grads(module, toks, tcfg_r)
    np.testing.assert_allclose(loss_r, loss0, rtol=1e-6)
    jcfg_r = dataclasses.replace(jcfg, remat=remat)
    want_loss, want = jax.value_and_grad(jax_loss(jcfg_r, toks))(jparams)
    want = named(want)
    np.testing.assert_allclose(loss_r, float(want_loss), rtol=2e-4)
    assert sorted(grads_r) == sorted(want)
    for name in want:
        np.testing.assert_allclose(grads_r[name], grads0[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(grads_r[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _subjaxprs(eqn):
    for value in eqn.params.values():
        for x in value if isinstance(value, (tuple, list)) else (value,):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def pallas_calls(jaxpr, mult=1, counts=None):
    """{outputs of the kernel: pallas_call equations run} over ``jaxpr``
    and every sub-jaxpr, a scan body counted ``length`` times.  The flash
    kernels are told apart by their outputs: B3 three (out, l, m), B4 one
    (dq), B5 two (dk, dv)."""
    counts = collections.Counter() if counts is None else counts
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            counts[len(eqn.params["out_avals"])] += mult
            continue
        inner = mult * eqn.params["length"] if eqn.primitive.name == "scan" \
            else mult
        for sub in _subjaxprs(eqn):
            pallas_calls(sub, inner, counts)
    return counts


@pytest.fixture
def counted_wrappers(monkeypatch):
    """Each call of the wrappers that launch B3, B4 and B5 on the card
    adds to that kernel's launch counter, here on the CPU too."""
    forward, backward = tfa.flash_forward, tfa.flash_backward

    def flash_forward(*args, **kwargs):
        tfa.LAUNCHES += 1
        return forward(*args, **kwargs)

    def flash_backward(*args, **kwargs):
        tfa.BWD_DQ_LAUNCHES += 1
        tfa.BWD_DKV_LAUNCHES += 1
        return backward(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_forward", flash_forward)
    monkeypatch.setattr(tfa, "flash_backward", flash_backward)
    for name in ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES"):
        monkeypatch.setattr(tfa, name, 0)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("remat", [False] + POLICIES, ids=str)
def test_launches_match_jax_pallas_calls(remat, moe, monkeypatch,
                                         counted_wrappers):
    monkeypatch.setenv("ELASTICDL_FLASH", "interpret")
    jcfg, jparams, tcfg, module = build(KERNEL, moe_experts=moe,
                                        remat=remat)
    toks = tokens(2, 128, seed=0)
    calls = pallas_calls(jax.make_jaxpr(jax.grad(jax_loss(jcfg, toks)))(
        jparams).jaxpr)
    want = (calls[3], calls[1], calls[2])
    L = tcfg.num_layers
    assert want == ((2 if remat else 1) * L, L, L)
    assert sum(calls.values()) == sum(want)      # no other pallas_call
    port_loss(module, toks, tcfg).backward()
    assert (tfa.LAUNCHES, tfa.BWD_DQ_LAUNCHES, tfa.BWD_DKV_LAUNCHES) == want


class _Ops(TorchDispatchMode):
    """Counts the aten ops run while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def backward_ops(module, toks, cfg):
    """(ops of the forward, ops of the backward) of one step."""
    module.zero_grad(set_to_none=True)
    with _Ops() as fwd:
        loss = port_loss(module, toks, cfg)
    with _Ops() as bwd:
        loss.backward()
    return fwd.ops, bwd.ops


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_policies_recompute_what_jax_recomputes(moe):
    _, _, tcfg, module = build(SMALL, moe_experts=moe)
    toks = tokens(2, 16, seed=5)
    ops = {remat: backward_ops(module, toks,
                               dataclasses.replace(tcfg, remat=remat))
           for remat in [False] + POLICIES}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    named_out = torch.ops.elasticdl_tpu_torch.checkpoint_name.default
    bwd = {remat: ops[remat][1] for remat in ops}
    # remat=True runs every forward product of the layers again
    assert bwd[True][mm] > bwd[False][mm]
    assert bwd[True][bmm] > bwd[False][bmm]
    # "dots" keeps the weight products and recomputes the batched ones
    assert bwd["dots"][mm] == bwd[False][mm]
    assert bwd["dots"][bmm] == bwd[True][bmm]
    # "attn" keeps the attention output it names, and only that
    assert ops["attn"][0][named_out] == tcfg.num_layers
    assert bwd["attn"][named_out] == 0
    assert bwd["attn"][mm] == bwd[True][mm]
    assert bwd["attn"][bmm] == bwd[True][bmm]
    for remat in (False, True, "dots"):
        assert ops[remat][0][named_out] == 0
