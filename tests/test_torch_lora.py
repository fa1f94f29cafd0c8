"""LoRA fine-tuning of the flagship LM in the port
(elasticdl_tpu_torch/models/lora.py), the port of tests/test_lora.py
with the JAX package's LoRA alongside on the CPU.

Contracts, as in the JAX tests: zero-delta init reproduces the base
model; training moves only the adapters (the frozen base is bitwise
unchanged and holds no optimizer state); the merge folds the adaptation
into a plain transformer that forward, generate and export take with no
LoRA code; pretrain, export, adapt from the export.  Against the JAX
package: the same weights (carried by name) give the same logits, and
AdamW steps through both trainers give the same parameters and the same
checkpoint names (optax ``multi_transform``'s ``inner_states/...``).

Tolerances: the JAX tests' own where ported (zero-delta 1e-6, the fold
2e-5, chunked against dense loss 1e-5); against the JAX package,
logits 1e-5 relative + 1e-6 absolute and losses 2e-4 relative (float32,
sums in other orders); parameters after AdamW steps 1e-4 absolute, as
tests/test_torch_transformer_train.py holds AdamW (the update divides by
sqrt(nu)); moments after the steps 1e-4 relative + 1e-4 x the largest
entry of the moment absolute (the gradients' tolerance carried through
the moving averages).
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import lora as jlora
from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.models.callbacks import ModelExporter
from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu.utils.pytree import to_numpy
from elasticdl_tpu.worker.collective_trainer import (
    CollectiveTrainer as JTrainer)
from elasticdl_tpu_torch.models import lora
from elasticdl_tpu_torch.models import transformer as tfm
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer

LM_KW = dict(vocab_size=128, dim=32, num_heads=4, num_layers=2,
             seq_len=16, dtype="float32")


def make_tokens(b, t, seed):
    return np.random.RandomState(seed).randint(
        0, 128, size=(b, t)).astype(np.int32)


def params_of(module):
    return {name: p.detach().clone() for name, p in
            module.named_parameters()}


def trainer(spec, **kwargs):
    return CollectiveTrainer(spec, batch_size=4, device="cpu", **kwargs)


def test_zero_delta_init_matches_base():
    spec = lora.model_spec(rank=4, **LM_KW)
    module = spec.init_fn("cpu")
    toks = torch.from_numpy(make_tokens(2, 8, seed=1))
    with torch.no_grad():
        got = spec.apply_fn(module, toks, False)
        want = tfm.forward(module.base, toks, spec.config)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"lora_targets": "wq,w_up",
                                         "num_kv_heads": 2, "window": 4},
                                    {"moe_experts": 2}],
                         ids=["attention", "mlp_gqa_window", "moe"])
def test_logits_match_jax_with_trained_adapters(kwargs):
    """The JAX spec's params, B made nonzero, carried into the port by
    name: both apply_fns give the same logits."""
    jspec = jlora.model_spec(rank=2, alpha=8, **LM_KW, **kwargs)
    jparams = to_numpy(jspec.init_fn(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    for ab in jparams["lora"].values():
        ab["B"] = (rng.randn(*ab["B"].shape) * 0.1).astype(np.float32)
    spec = lora.model_spec(rank=2, alpha=8, **LM_KW, **kwargs)
    module = spec.init_fn("cpu")
    named = {k: np.asarray(v) for k, v in
             flatten_with_names(jparams)[0].items()}
    module.load_state_dict(spec.params_from_jax(named))
    toks = make_tokens(2, 16, seed=4)
    want = np.asarray(jspec.apply_fn(jparams, toks, False))
    with torch.no_grad():
        got = spec.apply_fn(module, torch.from_numpy(toks), False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_training_moves_only_adapters():
    spec = lora.model_spec(rank=4, **LM_KW)
    t = trainer(spec)
    before = params_of(t.module)
    toks = make_tokens(4, 16, seed=2)
    losses = [float(t.train_minibatch(toks, toks)[0]) for _ in range(8)]
    after = params_of(t.module)
    for name in before:
        if name.startswith("base."):
            assert torch.equal(before[name], after[name]), name
    moved = [name.split(".")[1] for name in after
             if name.endswith(".B") and after[name].abs().max() > 0]
    assert sorted(moved) == sorted(lora.DEFAULT_TARGETS), moved
    assert losses[-1] < losses[0], losses
    state = t._optimizer.state
    held = sorted(name for name, p in t.module.named_parameters()
                  if p in state)
    assert held == sorted(n for n in after if n.startswith("lora."))
    assert all(t.module.get_parameter(n).grad is None
               for n in after if n.startswith("base."))


def test_merged_params_fold_exactly():
    spec = lora.model_spec(rank=4, alpha=8, **LM_KW)
    t = trainer(spec)
    toks = make_tokens(4, 16, seed=3)
    for _ in range(3):
        t.train_minibatch(toks, toks)
    merged = lora.merged_params(t.module, scaling=spec.lora["scaling"])
    assert isinstance(merged, tfm.TransformerLM)
    probe = torch.from_numpy(make_tokens(2, 8, seed=4))
    with torch.no_grad():
        want = spec.apply_fn(t.module, probe, False)
        got = tfm.forward(merged, probe, spec.config)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    out = tfm.generate(merged, spec.config, probe, max_new_tokens=3)
    assert out.shape == (2, 11)


def test_adapt_from_base_export(tmp_path):
    """Pretrain in the port, export with ``export_generate``, adapt from
    the export; and from the JAX package's ``ModelExporter`` export."""
    base_spec = tfm.model_spec(**LM_KW)
    t = trainer(base_spec)
    toks = make_tokens(4, 16, seed=5)
    t.train_minibatch(toks, toks)
    port_dir = str(tmp_path / "port")
    tfm.export_generate(port_dir, t.module, base_spec.config,
                        max_new_tokens=4, prompt_len=4)
    jt = JTrainer(jtfm.model_spec(**LM_KW), batch_size=4)
    jt.train_minibatch(toks, toks)
    jax_dir = str(tmp_path / "jax")
    ModelExporter(jax_dir, model_name="lm").on_train_end(jt)
    for export_dir, want in ((port_dir, t.export_parameters()),
                             (jax_dir, jt.export_parameters())):
        spec = lora.model_spec(rank=4, base_export=export_dir, **LM_KW)
        got = tfm.params_to_jax(spec.init_fn("cpu", seed=7).base)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    wide = lora.model_spec(rank=4, base_export=port_dir,
                           **dict(LM_KW, moe_experts=2))
    with pytest.raises(ValueError, match="wrong architecture"):
        wide.init_fn("cpu")


def test_int8_base_export_is_not_ported(tmp_path):
    """An export whose weights are int8 with a scale (the JAX package's
    ``q8/<name>``, ``q8scale/<name>`` entries) loads as a LoRA base: the
    base gets the dequantized weights (int8 exports are ported, ROADMAP
    A11; the name is kept from when they were refused)."""
    spec = tfm.model_spec(**LM_KW)
    module = spec.init_fn("cpu")
    export_dir = str(tmp_path / "q8")
    tfm.export_generate(export_dir, module, spec.config, max_new_tokens=4,
                        prompt_len=4)
    path = tmp_path / "q8" / "model.npz"
    with np.load(path) as z:
        payload = {key: z[key] for key in z.files}
    wq = payload.pop("layers/wq")
    scale = np.abs(wq).max() / 127.0
    payload["q8/layers/wq"] = np.round(wq / scale).astype(np.int8)
    payload["q8scale/layers/wq"] = np.float32(scale)
    np.savez(path, **payload)
    spec = lora.model_spec(rank=2, base_export=export_dir, **LM_KW)
    loaded = spec.init_fn("cpu")
    want = payload["q8/layers/wq"].astype(np.float32) * np.float32(scale)
    np.testing.assert_array_equal(
        loaded.base.state_dict()["layers.wq"].numpy(), want)
    np.testing.assert_array_equal(
        loaded.base.state_dict()["layers.wk"].numpy(), payload["layers/wk"])


def test_mlp_targets_and_gqa_window_variant():
    spec = lora.model_spec(
        rank=2, lora_targets="wq,wo,w_gate,w_up,w_down",
        num_kv_heads=2, window=4, **LM_KW)
    module = spec.init_fn("cpu")
    assert sorted(name for name, _ in module.lora.named_children()) == [
        "w_down", "w_gate", "w_up", "wo", "wq"]
    toks = torch.from_numpy(make_tokens(2, 16, seed=6))
    with torch.no_grad():
        out = spec.apply_fn(module, toks, False)
        want = tfm.forward(module.base, toks, spec.config)
    assert out.shape == (2, 16, 128)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_train_norms_variant_moves_norms_without_decay():
    spec = lora.model_spec(rank=2, train_norms=True, **LM_KW)
    t = trainer(spec)
    before = params_of(t.module)
    toks = make_tokens(4, 16, seed=8)
    for _ in range(4):
        t.train_minibatch(toks, toks)
    after = params_of(t.module)
    for name in ("base.ln_f", "base.layers.ln1", "base.layers.ln2"):
        assert not torch.equal(before[name], after[name]), name
    for name in ("base.embed", "base.layers.wq", "base.layers.w_up"):
        assert torch.equal(before[name], after[name]), name
    adapters, norms = t._optimizer.param_groups
    assert adapters["weight_decay"] == 0.01 and norms["weight_decay"] == 0.0
    assert len(norms["params"]) == 3


def test_lora_with_chunked_xent_matches_dense_loss():
    toks = make_tokens(4, 16, seed=20)
    losses = {}
    for chunk in (0, 8):
        spec = lora.model_spec(rank=2, xent_chunk=chunk, **LM_KW)
        loss, _ = trainer(spec).train_minibatch(toks, toks)
        losses[chunk] = float(loss)
    assert abs(losses[0] - losses[8]) < 1e-5, losses


def test_lora_on_moe_config():
    spec = lora.model_spec(rank=2, moe_experts=2, **LM_KW)
    module = spec.init_fn("cpu")
    toks = torch.from_numpy(make_tokens(2, 8, seed=30))
    with torch.no_grad():
        got = spec.apply_fn(module, toks, False)
        want = tfm.forward(module.base, toks, spec.config)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    bad = lora.model_spec(rank=2, moe_experts=2, lora_targets="wq,w_gate",
                          **LM_KW)
    with pytest.raises(ValueError, match="rank-4"):
        bad.init_fn("cpu")
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora.model_spec(rank=2, lora_targets="wx", **LM_KW).init_fn("cpu")


def saved(path, version):
    with np.load(path / ("version-%d" % version) / "variables-0-of-1.ckpt"
                 ) as z:
        return {k[len("dense/"):]: z[k] for k in z.files}


@pytest.mark.parametrize("train_norms", [False, True])
def test_adamw_steps_and_checkpoint_names_match_optax(tmp_path,
                                                      train_norms):
    """The port's trainer and the JAX trainer from the same weights: three
    AdamW steps give the same losses and parameters, and each writes a
    checkpoint with the same names (optax ``multi_transform``'s
    ``inner_states/<label>/inner_state/0/...``, counts included), shapes
    and, within the tolerances, values."""
    kw = dict(rank=2, train_norms=train_norms, learning_rate=1e-3, **LM_KW)
    spec, jspec = lora.model_spec(**kw), jlora.model_spec(**kw)
    port = trainer(spec, checkpoint_saver=CheckpointSaver(
        str(tmp_path / "port")), checkpoint_steps=3)
    jt = JTrainer(jspec, batch_size=4, checkpoint_saver=JSaver(
        str(tmp_path / "jax")), checkpoint_steps=3)
    port.set_params(spec.params_from_jax(
        flatten_with_names(to_numpy(jt.params))[0]))
    toks = make_tokens(12, 16, seed=9)
    for i in range(3):
        batch = toks[4 * i:4 * i + 4]
        want, _ = jt.train_minibatch(batch, batch)
        got, _ = port.train_minibatch(batch, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    port.flush_checkpoints()
    jt.flush_checkpoints()
    mine, theirs = saved(tmp_path / "port", 3), saved(tmp_path / "jax", 3)
    assert sorted(mine) == sorted(theirs)
    norm_mu = "opt/inner_states/train_norm/inner_state/0/mu/base/ln_f"
    assert (norm_mu in mine) == train_norms
    assert "opt/inner_states/train/inner_state/0/mu/lora/wq/A" in mine
    for name in theirs:
        assert mine[name].shape == theirs[name].shape, name
        if name.endswith("/count"):
            assert int(mine[name]) == int(theirs[name]) == 3, name
        elif name.startswith("opt/"):
            np.testing.assert_allclose(
                mine[name], theirs[name], rtol=1e-4,
                atol=1e-4 * np.abs(theirs[name]).max(), err_msg=name)
        else:
            np.testing.assert_allclose(mine[name], theirs[name], rtol=0,
                                       atol=1e-4, err_msg=name)


def test_jax_lora_checkpoint_resumes_in_the_port(tmp_path):
    toks = make_tokens(4, 16, seed=10)
    kw = dict(rank=2, train_norms=True, learning_rate=1e-3, **LM_KW)
    jspec = jlora.model_spec(**kw)
    ref = JTrainer(jspec, batch_size=4, rng_seed=4)
    losses_ref = [float(ref.train_minibatch(toks, toks)[0])
                  for _ in range(4)]
    t1 = JTrainer(jspec, batch_size=4, rng_seed=4,
                  checkpoint_saver=JSaver(str(tmp_path)),
                  checkpoint_steps=2)
    t1.train_minibatch(toks, toks)
    t1.train_minibatch(toks, toks)   # checkpoint at version 2
    t1.flush_checkpoints()
    slots = saved(tmp_path, 2)
    port = trainer(lora.model_spec(**kw), rng_seed=99,
                   checkpoint_saver=CheckpointSaver(str(tmp_path)))
    assert port.init_from_checkpoint() and port.version == 2
    state = port._optimizer.state
    for name, p in port.module.named_parameters():
        jname = name.replace(".", "/")
        group = ("train" if name.startswith("lora.") else "train_norm")
        prefix = "opt/inner_states/%s/inner_state/0/" % group
        if p.requires_grad:
            np.testing.assert_array_equal(state[p]["exp_avg"].numpy(),
                                          slots[prefix + "mu/" + jname])
            assert int(state[p]["step"]) == 2
        else:
            assert p not in state
    resumed = [float(port.train_minibatch(toks, toks)[0]) for _ in range(2)]
    np.testing.assert_allclose(resumed, losses_ref[2:], rtol=2e-4)
