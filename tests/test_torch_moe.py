"""The port's mixture-of-experts FFN and MoE language model
(elasticdl_tpu_torch/models/transformer.py: ``_moe_ffn``, the MoE leaves
of ``init_params``, the MoE branch of the layer and of decode, the zoo
entry's aux loss) against the JAX package's on the CPU.  The same weights
(drawn by numpy or by the JAX ``init_params``, carried by name with no
transposes) and the same numpy token ids go into both.

Tolerances, float32 on both sides, which sum in other orders:
``_moe_ffn`` out 1e-5 relative + 1e-6 absolute, aux and the router
statistics 1e-6 relative + 1e-7 absolute; whole-model logits 5e-4 (the
JAX package's own MoE parity tolerance, tests/test_transformer.py) and
gradients 1e-4 relative + 1e-5 absolute (its remat gradient tolerance);
greedy tokens and the top-k choices exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu.worker.collective_trainer import (
    CollectiveTrainer as JTrainer)
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.serving.loader import load_servable
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer

FFN_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_TOL = dict(rtol=1e-6, atol=1e-7)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BASE = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
            max_seq_len=32, dtype="float32", moe_experts=4)
SPEC_ARGS = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
                 seq_len=32, dtype="float32", learning_rate=1e-3,
                 moe_experts=4)


def named(jparams):
    return {k: np.asarray(v)
            for k, v in flatten_with_names(jparams)[0].items()}


def build(seed=3, **overrides):
    """(JAX cfg, JAX params, port cfg, port module), same weights."""
    kw = dict(BASE, **overrides)
    jcfg, tcfg = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    module = ttfm.TransformerLM(tcfg)
    module.load_state_dict(ttfm.params_from_jax(named(jparams)))
    return jcfg, jparams, tcfg, module


def tokens(b, t, seed, vocab=BASE["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)
                                               ).astype(np.int32)


def expert_weights(rng, E, X, F, router):
    return {"w_router": router.astype(np.float32),
            "w_gate": (rng.randn(X, E, F) * 0.1).astype(np.float32),
            "w_up": (rng.randn(X, E, F) * 0.1).astype(np.float32),
            "w_down": (rng.randn(X, F, E) * 0.1).astype(np.float32)}


def both_moe_ffn(h, w, **cfg_kw):
    kw = dict(vocab_size=16, dim=h.shape[-1], num_heads=1, num_layers=1,
              mlp_ratio=2, dtype="float32", **cfg_kw)
    want = jtfm._moe_ffn(jnp.asarray(h), {k: jnp.asarray(v)
                                          for k, v in w.items()},
                         jtfm.TransformerConfig(**kw), None)
    got = ttfm._moe_ffn(torch.from_numpy(h), {k: torch.from_numpy(v)
                                              for k, v in w.items()},
                        ttfm.TransformerConfig(**kw))
    return ([np.asarray(x) for x in want],
            [x.detach().numpy() for x in got])


# (top_k, capacity factor, router): the router's scale 0 gives exact ties
# among all experts; 1e3 saturates the softmax into exact 1.0 and 0.0
# entries, so the later choices tie among the zeros.  A capacity factor of
# 0.25 gives a capacity of 3 slots for 16 tokens at top-2, so tokens
# overflow to their other choice and to the residual.
FFN_CASES = {
    "top1": (1, 2.0, 0.02),
    "top2": (2, 2.0, 0.02),
    "top2_overflow": (2, 0.25, 0.02),
    "top1_overflow": (1, 0.25, 1.0),
    "top2_zero_router": (2, 2.0, 0.0),
    "top2_zero_router_overflow": (2, 0.25, 0.0),
    "top2_saturated_router": (2, 2.0, 1e3),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    top_k, capacity_factor, router_scale = FFN_CASES[case]
    rng = np.random.RandomState(0)
    B, T, E, X, F = 2, 16, 8, 4, 16
    h = rng.randn(B, T, E).astype(np.float32)
    w = expert_weights(rng, E, X, F, rng.randn(E, X) * router_scale)
    (out_j, aux_j, stats_j), (out_t, aux_t, stats_t) = both_moe_ffn(
        h, w, moe_experts=X, moe_top_k=top_k,
        moe_capacity_factor=capacity_factor)
    np.testing.assert_allclose(out_t, out_j, **FFN_TOL)
    np.testing.assert_allclose(aux_t, aux_j, **AUX_TOL)
    np.testing.assert_allclose(stats_t, stats_j, **AUX_TOL)
    if "overflow" in case:
        # some token kept none of its experts: its FFN output is 0
        assert (np.abs(out_j).max(axis=-1) == 0).any()


def test_top_k_breaks_ties_as_jax():
    """Rows with exact ties (all equal, pairs equal, zeros after a 1.0)
    give the indices ``jax.lax.top_k`` gives: the lower index first."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.0, 0.0, 1.0, 0.0],
                     [0.3, 0.2, 0.3, 0.2],
                     [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3, 4):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows), k)
        got_v, got_i = ttfm._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_leaves_in_the_jax_layout():
    """The port's module holds the JAX ``init_params`` leaves under the
    same names and shapes ([L, E, X] router, [L, X, E, F] gate and up,
    [L, X, F, E] down), and ``params_to_jax`` gives them back unchanged."""
    _, jparams, tcfg, module = build()
    want = named(jparams)
    got = ttfm.params_to_jax(module)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert got["layers/w_gate"].shape == (2, 4, 64, 256)
    assert got["layers/w_down"].shape == (2, 4, 256, 64)
    assert got["layers/w_router"].shape == (2, 64, 4)
    fresh = ttfm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == {
        n: tuple(p.shape) for n, p in module.named_parameters()}
    # init_params' families: N(0, 0.02^2) router, N(0, 1/fan_in) experts
    with torch.no_grad():
        assert abs(float(fresh.layers.w_router.std()) - 0.02) < 0.004
        assert abs(float(fresh.layers.w_down.std()) - 256 ** -0.5) < 0.01


def jax_loss_and_grads(jparams, toks, jcfg):
    def loss(p):
        logits, aux = jtfm.forward(p, toks, jcfg, return_aux=True)
        return (jtfm.next_token_loss(logits, toks).mean()
                + jcfg.moe_aux_weight * aux)

    value, grads = jax.value_and_grad(loss)(jparams)
    return float(value), named(grads)


def port_loss_and_grads(module, toks, tcfg):
    module.zero_grad(set_to_none=True)
    toks = torch.from_numpy(toks)
    logits, aux = ttfm.forward(module, toks, tcfg, return_aux=True)
    loss = ttfm.next_token_loss(logits, toks).mean() + (
        tcfg.moe_aux_weight * aux)
    loss.backward()
    return float(loss.detach()), {
        name.replace(".", "/"): p.grad.clone().numpy()
        for name, p in module.named_parameters()}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_model_logits_aux_and_grads_match_jax(top_k):
    jcfg, jparams, tcfg, module = build(moe_top_k=top_k)
    toks = tokens(2, 32, seed=1)
    want_logits, want_aux = jtfm.forward(jparams, toks, jcfg,
                                         return_aux=True)
    with torch.no_grad():
        got_logits, got_aux = ttfm.forward(module, torch.from_numpy(toks),
                                           tcfg, return_aux=True)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **AUX_TOL)
    want_loss, want = jax_loss_and_grads(jparams, toks, jcfg)
    got_loss, got = port_loss_and_grads(module, toks, tcfg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-4)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(got[name]).max() > 0, name   # router and experts too
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("variant", [{}, {"num_kv_heads": 2, "window": 8},
                                     {"moe_top_k": 1}])
def test_moe_greedy_generate_matches_jax(variant):
    jcfg, jparams, tcfg, module = build(seed=9, **variant)
    prompt = tokens(2, 5, seed=10)
    want = np.asarray(jtfm.generate(jparams, jcfg, prompt, 6))
    got = ttfm.generate(module, tcfg, prompt, 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_aux_loss_signals_imbalance():
    """The Switch aux: about 1 for a near-uniform router, about X under
    collapse; the port's values equal the JAX package's."""
    rng = np.random.RandomState(0)
    B, T, E, X, F = 2, 16, 8, 4, 16
    h = (np.abs(rng.randn(B, T, E)) + 0.1).astype(np.float32)
    balanced = expert_weights(rng, E, X, F, rng.randn(E, X) * 0.02)
    collapse = np.zeros((E, X))
    collapse[:, 0] = 10.0            # every (positive) token votes expert 0
    collapsed = expert_weights(rng, E, X, F, collapse)
    auxes = []
    for w in (balanced, collapsed):
        (_, aux_j, _), (_, aux_t, _) = both_moe_ffn(
            h, w, moe_experts=X, moe_top_k=2)
        np.testing.assert_allclose(aux_t, aux_j, **AUX_TOL)
        auxes.append(float(aux_t))
    assert auxes[0] < 1.5 and auxes[1] > 3.0, auxes


def test_moe_top2_uses_second_expert():
    """Top-2 combines both chosen experts: its logits differ from top-1's
    on the same weights, in the port as in the JAX package."""
    _, _, tcfg, module = build(seed=5)
    toks = torch.from_numpy(tokens(2, 32, seed=0))
    with torch.no_grad():
        out2 = ttfm.forward(module, toks, tcfg)
        out1 = ttfm.forward(module, toks,
                            dataclasses.replace(tcfg, moe_top_k=1))
    assert torch.isfinite(out2).all()
    assert not torch.allclose(out2, out1)


def test_zoo_entry_trains_with_the_aux_loss():
    """The zoo entry's training output is (logits, aux) and its loss
    xent + moe_aux_weight x aux, dense and chunked; evaluation gives the
    logits alone."""
    spec = ttfm.model_spec(**SPEC_ARGS, moe_aux_weight=0.5)
    chunked = ttfm.model_spec(**SPEC_ARGS, moe_aux_weight=0.5,
                              xent_chunk=8)
    module = spec.init_fn("cpu", seed=1)
    toks = torch.from_numpy(tokens(2, 32, seed=2))
    logits, aux = spec.apply_fn(module, toks, True)
    want = ttfm.next_token_loss(logits, toks) + 0.5 * aux
    got = spec.loss_fn((logits, aux), toks)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), rtol=1e-6)
    got_chunked = chunked.loss_fn(chunked.apply_fn(module, toks, True), toks)
    np.testing.assert_allclose(got_chunked.detach().numpy(),
                               want.detach().numpy(), rtol=1e-5)
    assert spec.apply_fn(module, toks, False).shape == (2, 32, 128)


def saved_slots(path, version):
    with np.load(path / ("version-%d" % version) / "variables-0-of-1.ckpt"
                 ) as z:
        return {k[len("dense/"):]: z[k] for k in z.files}


def test_jax_moe_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint of the MoE LM (parameters and AdamW moments, the
    4-D expert leaves among them) restores into the port untransposed, and
    the port follows JAX's uninterrupted loss curve."""
    toks = tokens(4, 32, seed=7)
    jspec = jtfm.model_spec(**SPEC_ARGS)
    ref = JTrainer(jspec, batch_size=4, rng_seed=4)
    losses_ref = [float(ref.train_minibatch(toks, toks)[0])
                  for _ in range(4)]
    t1 = JTrainer(jspec, batch_size=4, rng_seed=4,
                  checkpoint_saver=JSaver(str(tmp_path)),
                  checkpoint_steps=2)
    t1.train_minibatch(toks, toks)
    t1.train_minibatch(toks, toks)   # checkpoint at version 2
    t1.flush_checkpoints()
    saved = saved_slots(tmp_path, 2)
    assert saved["opt/0/mu/layers/w_gate"].shape == (2, 4, 64, 256)

    port = CollectiveTrainer(ttfm.model_spec(**SPEC_ARGS), batch_size=4,
                             device="cpu", rng_seed=99,
                             checkpoint_saver=CheckpointSaver(str(tmp_path)))
    assert port.init_from_checkpoint() and port.version == 2
    state = port._optimizer.state
    for name, p in port.module.named_parameters():
        jname = name.replace(".", "/")
        np.testing.assert_array_equal(p.detach().numpy(), saved[jname])
        np.testing.assert_array_equal(state[p]["exp_avg"].numpy(),
                                      saved["opt/0/mu/" + jname])
        np.testing.assert_array_equal(state[p]["exp_avg_sq"].numpy(),
                                      saved["opt/0/nu/" + jname])
    resumed = [float(port.train_minibatch(toks, toks)[0]) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=2e-4)


def test_port_moe_checkpoint_resumes_in_jax(tmp_path):
    toks = tokens(4, 32, seed=8)
    spec = ttfm.model_spec(**SPEC_ARGS)
    ref = CollectiveTrainer(spec, batch_size=4, device="cpu", rng_seed=5)
    losses_ref = [float(ref.train_minibatch(toks, toks)[0])
                  for _ in range(4)]
    t1 = CollectiveTrainer(spec, batch_size=4, device="cpu", rng_seed=5,
                           checkpoint_saver=CheckpointSaver(str(tmp_path)),
                           checkpoint_steps=2)
    t1.train_minibatch(toks, toks)
    t1.train_minibatch(toks, toks)   # checkpoint at version 2
    t1.flush_checkpoints()
    saved = saved_slots(tmp_path, 2)
    assert saved["opt/0/nu/layers/w_down"].shape == (2, 4, 256, 64)

    jtrainer = JTrainer(jtfm.model_spec(**SPEC_ARGS), batch_size=4,
                        rng_seed=99, checkpoint_saver=JSaver(str(tmp_path)))
    assert jtrainer.init_from_checkpoint() and jtrainer.version == 2
    mu = named(jtrainer._opt_state[0].mu)
    for name, value in mu.items():
        np.testing.assert_array_equal(value, saved["opt/0/mu/" + name])
    resumed = [float(jtrainer.train_minibatch(toks, toks)[0])
               for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=2e-4)


def test_moe_export_serves_generate(tmp_path):
    """``export_generate`` of an MoE LM records the MoE settings in its zoo
    entry; the loaded servable answers what ``generate`` gives."""
    _, _, tcfg, module = build(seed=11, moe_top_k=1, moe_aux_weight=0.05)
    assert "moe_experts=4;moe_top_k=1;moe_aux_weight=0.05" in (
        ttfm.zoo_params(tcfg))
    ttfm.export_generate(str(tmp_path / "lm"), module, tcfg,
                         max_new_tokens=4, prompt_len=6)
    served = load_servable(str(tmp_path / "lm"), device="cpu")
    assert served.module.cfg == tcfg
    prompt = tokens(3, 6, seed=12)
    np.testing.assert_array_equal(
        served.predict(prompt), ttfm.generate(module, tcfg, prompt, 4))
    with pytest.raises(ValueError, match="moe_capacity_factor"):
        ttfm.zoo_params(dataclasses.replace(tcfg, moe_capacity_factor=1.0))
