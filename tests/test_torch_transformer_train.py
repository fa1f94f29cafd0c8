"""The port's flagship transformer LM, training path
(elasticdl_tpu_torch/models/transformer.py: ``next_token_loss``,
``next_token_loss_chunked``, ``remat``, the zoo entry's loss and AdamW;
worker/collective_trainer.py with its checkpoints), against the JAX
package's on the CPU.  The same weights (drawn by the JAX
``init_params``, mapped by name with no transposes) and the same numpy
token ids go into both.

Tolerances: losses 2e-4 relative and gradients 1e-4 relative + 1e-5
absolute, float32 on both sides, which sum in other orders (the JAX
package's own remat and chunked-loss tests use 1e-4 / 1e-5 and 1e-4 /
1e-6 on one side).  Through the trainer, parameters after three AdamW
steps at atol 1e-4, as tests/test_torch_trainer.py holds Adam: the
update divides by sqrt(nu), so an entry whose gradient is near zero
moves by a share of the learning rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu.utils.pytree import to_numpy
from elasticdl_tpu.utils.pytree import unflatten_from_names
from elasticdl_tpu.worker.collective_trainer import (
    CollectiveTrainer as JTrainer)
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer

LOSS_RTOL = 2e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BASE = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
            max_seq_len=32, dtype="float32")
VARIANTS = {
    "dense": {},
    "gqa": {"num_kv_heads": 2},
    "window": {"window": 8},
    "gqa+window": {"num_kv_heads": 2, "window": 8},
}
SPEC_ARGS = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
                 seq_len=32, dtype="float32", learning_rate=1e-3)


def named(jparams):
    return {k: np.asarray(v)
            for k, v in flatten_with_names(jparams)[0].items()}


def build(seed=7, **overrides):
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


def jax_loss_and_grads(jparams, toks, jcfg, chunk=0):
    def loss(p):
        if chunk:
            hidden, _ = jtfm.forward_hidden(p, toks, jcfg)
            per = jtfm.next_token_loss_chunked(p, hidden, toks, jcfg,
                                               chunk=chunk)
        else:
            per = jtfm.next_token_loss(jtfm.forward(p, toks, jcfg), toks)
        return per.mean()

    value, grads = jax.value_and_grad(loss)(jparams)
    return float(value), named(grads)


def port_loss_and_grads(module, toks, tcfg, chunk=0):
    module.zero_grad(set_to_none=True)
    toks = torch.from_numpy(toks)
    if chunk:
        hidden, _ = ttfm.forward_hidden(module, toks, tcfg)
        per = ttfm.next_token_loss_chunked(module, hidden, toks, tcfg,
                                           chunk=chunk)
    else:
        per = ttfm.next_token_loss(ttfm.forward(module, toks, tcfg), toks)
    loss = per.mean()
    loss.backward()
    grads = {name.replace(".", "/"): p.grad.clone()
             for name, p in module.named_parameters()}
    return float(loss.detach()), grads


def assert_grads_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   err_msg=name, **(tol or GRAD_TOL))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    jcfg, jparams, tcfg, module = build(**VARIANTS[variant])
    toks = tokens(2, 16, seed=1)
    want_loss, want = jax_loss_and_grads(jparams, toks, jcfg)
    got_loss, got = port_loss_and_grads(module, toks, tcfg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert_grads_close(got, want)


def test_grads_match_jax_through_its_pallas_backward(monkeypatch):
    """With ELASTICDL_FLASH=interpret the JAX transformer's attention is
    the Pallas kernel and its gradient the Pallas pair (head_dim 64,
    T=128); the port's plain backward matches it."""
    monkeypatch.setenv("ELASTICDL_FLASH", "interpret")
    called = []
    orig = jfa._pallas_bwd
    monkeypatch.setattr(jfa, "_pallas_bwd", lambda *a, **kw: (
        called.append(True), orig(*a, **kw))[1])
    jcfg, jparams, tcfg, module = build(dim=128, num_heads=2,
                                        max_seq_len=128)
    toks = tokens(2, 128, seed=2)
    want_loss, want = jax_loss_and_grads(jparams, toks, jcfg)
    assert called, "the JAX backward did not take _pallas_bwd"
    got_loss, got = port_loss_and_grads(module, toks, tcfg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert_grads_close(got, want)


@pytest.mark.parametrize("chunk", [8, 12, 32])
def test_chunked_loss_matches_dense_and_jax(chunk):
    """chunk=12 pads T-1=31 to 36; chunk=32 is one padded chunk."""
    jcfg, jparams, tcfg, module = build(seed=0)
    toks = tokens(2, 32, seed=3)
    dense_loss, dense = port_loss_and_grads(module, toks, tcfg)
    got_loss, got = port_loss_and_grads(module, toks, tcfg, chunk=chunk)
    np.testing.assert_allclose(got_loss, dense_loss, rtol=1e-6)
    assert_grads_close(got, {k: v.numpy() for k, v in dense.items()},
                       rtol=1e-4, atol=1e-6)
    want_loss, want = jax_loss_and_grads(jparams, toks, jcfg, chunk=chunk)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert_grads_close(got, want)


@pytest.mark.parametrize("variant", ["dense", "gqa+window"])
def test_remat_preserves_loss_and_grads(variant):
    _, _, tcfg, module = build(**VARIANTS[variant])
    toks = tokens(2, 16, seed=4)
    loss, grads = port_loss_and_grads(module, toks, tcfg)
    remat = dataclasses.replace(tcfg, remat=True)
    loss_r, grads_r = port_loss_and_grads(module, toks, remat)
    np.testing.assert_allclose(loss_r, loss, rtol=1e-6)
    assert_grads_close(grads_r, {k: v.numpy() for k, v in grads.items()},
                       rtol=1e-5, atol=1e-7)


def test_remat_and_xent_chunk_options_validate():
    def spec(**kw):
        return ttfm.model_spec(vocab_size=64, dim=32, num_heads=2,
                               num_layers=1, seq_len=16, **kw)

    assert spec(remat="True").config.remat is True
    assert spec(remat=" false ").config.remat is False
    assert spec(remat=True).config.remat is True
    for policy in ("dots", "attn", "DOTS", " Attn"):
        assert spec(remat=policy).config.remat == policy.strip().lower()
    with pytest.raises(ValueError, match="remat must be one of"):
        spec(remat="yes")
    with pytest.raises(ValueError, match="remat must be one of"):
        ttfm.TransformerConfig(remat="yes")
    chunked = spec(xent_chunk=8, dtype="float32")
    module = chunked.init_fn("cpu")
    toks = torch.from_numpy(tokens(2, 16, seed=5, vocab=64))
    out = chunked.apply_fn(module, toks, True)
    assert out[0] == "hidden" and out[3] is module
    loss = chunked.loss_fn(out, toks)
    dense = spec(dtype="float32")
    want = dense.loss_fn(dense.apply_fn(module, toks, True), toks)
    assert loss.shape == want.shape == (2,)
    np.testing.assert_allclose(loss.detach().numpy(),
                               want.detach().numpy(), rtol=1e-6)
    # Evaluation takes the logits path; its metric is the JAX entry's.
    assert chunked.apply_fn(module, toks, False).shape == (2, 16, 64)
    assert set(chunked.eval_metrics_fn()) == {"nll"}
    assert isinstance(chunked.optimizer(module.parameters()),
                      torch.optim.AdamW)


def jax_pair(batch_size, rng_seed=0, **kwargs):
    """A port trainer and a JAX trainer holding the port's weights."""
    spec = ttfm.model_spec(**SPEC_ARGS)
    trainer = CollectiveTrainer(spec, batch_size=batch_size, device="cpu",
                                rng_seed=rng_seed, **kwargs)
    jtrainer = JTrainer(jtfm.model_spec(**SPEC_ARGS), batch_size=batch_size)
    jtrainer.set_params(unflatten_from_names(
        to_numpy(jtrainer.params), trainer.export_parameters()))
    return jtrainer, trainer


def test_adamw_steps_match_jax_trainer():
    """Weight decay moves a parameter by lr x 0.01 x p per step, under the
    atol, so it is also held on its own: the port's parameters less those
    of the same steps without decay must be optax.adamw's decoupled decay
    term, -lr x 0.01 x (p_0 + p_1 + p_2), within half its norm (readings
    0.003-0.26 per leaf; a missing or doubled decay is off by 1)."""
    jtrainer, trainer = jax_pair(4, rng_seed=1)
    lr = SPEC_ARGS["learning_rate"]
    no_decay = CollectiveTrainer(
        dataclasses.replace(ttfm.model_spec(**SPEC_ARGS),
                            optimizer=lambda p: torch.optim.AdamW(
                                p, lr=lr, weight_decay=0.0)),
        batch_size=4, device="cpu", rng_seed=1)
    toks = tokens(12, 32, seed=6)
    history = [trainer.export_parameters()]
    for i in range(3):
        batch = toks[4 * i:4 * i + 4]
        want, _ = jtrainer.train_minibatch(batch, batch)
        got, _ = trainer.train_minibatch(batch, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        no_decay.train_minibatch(batch, batch)
        history.append(trainer.export_parameters())
    want, got = jtrainer.export_parameters(), trainer.export_parameters()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, rtol=0,
                                   err_msg=name)
    undecayed = no_decay.export_parameters()
    for name in got:
        decay = -lr * 0.01 * sum(p[name] for p in history[:3])
        gap = np.linalg.norm(got[name] - undecayed[name] - decay)
        assert gap <= 0.5 * np.linalg.norm(decay), name


def test_optax_adamw_state_names():
    """What ``flatten_with_names`` gives ``optax.adamw``'s state, the names
    the port's trainer writes: count, then mu and nu per parameter."""
    _, jparams, _, _ = build()
    state = optax.adamw(1e-3, weight_decay=0.01).init(jparams)
    names = set(flatten_with_names(state)[0])
    params = set(named(jparams))
    assert names == ({"0/count"} | {"0/mu/" + n for n in params}
                     | {"0/nu/" + n for n in params})


def saved_moments(path, version):
    with np.load(path / ("version-%d" % version) / "variables-0-of-1.ckpt"
                 ) as z:
        return {k[len("dense/"):]: z[k] for k in z.files
                if k.startswith("dense/opt/")}


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint with AdamW moments restores into the port with its
    moments in the JAX layout ([V, E] embed, [L, E] norms: nothing
    transposed), and the port follows JAX's uninterrupted loss curve."""
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
    moments = saved_moments(tmp_path, 2)
    assert moments["opt/0/mu/embed"].shape == (128, 64)

    port = CollectiveTrainer(ttfm.model_spec(**SPEC_ARGS), batch_size=4,
                             device="cpu", rng_seed=99,
                             checkpoint_saver=CheckpointSaver(str(tmp_path)))
    assert port.init_from_checkpoint() and port.version == 2
    state = port._optimizer.state
    for name, p in port.module.named_parameters():
        jname = name.replace(".", "/")
        np.testing.assert_array_equal(state[p]["exp_avg"].numpy(),
                                      moments["opt/0/mu/" + jname])
        np.testing.assert_array_equal(state[p]["exp_avg_sq"].numpy(),
                                      moments["opt/0/nu/" + jname])
        assert int(state[p]["step"]) == 2
    resumed = [float(port.train_minibatch(toks, toks)[0]) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=LOSS_RTOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
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
    moments = saved_moments(tmp_path, 2)
    assert moments["opt/0/mu/embed"].shape == (128, 64)
    assert moments["opt/0/nu/layers/ln1"].shape == (2, 64)
    assert int(moments["opt/0/count"]) == 2

    jtrainer = JTrainer(jtfm.model_spec(**SPEC_ARGS), batch_size=4,
                        rng_seed=99, checkpoint_saver=JSaver(str(tmp_path)))
    assert jtrainer.init_from_checkpoint() and jtrainer.version == 2
    mu = named(jtrainer._opt_state[0].mu)
    for name, value in mu.items():
        np.testing.assert_array_equal(value, moments["opt/0/mu/" + name])
    resumed = [float(jtrainer.train_minibatch(toks, toks)[0])
               for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=LOSS_RTOL)
