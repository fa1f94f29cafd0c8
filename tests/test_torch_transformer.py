"""The port's flagship transformer LM, serving path
(elasticdl_tpu_torch/models/transformer.py), against the JAX package's
on the CPU: the same weights (drawn by the JAX ``init_params``, mapped by
name with no transposes) and the same numpy token ids go into both.

Tolerance 2e-4 abs/rel on float32 logits, the one of
``test_transformer_hits_flash_path`` (attention and matmuls sum in
other orders).  Greedy tokens must be equal; each test first asserts
that the top-2 logit margin at every generated position exceeds 5x
that tolerance, so the equality is not luck.
"""

import dataclasses
import http.client
import json
import threading
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.serving import server as tserver

TOL = 2e-4
MARGIN = 5 * TOL
BASE = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
            max_seq_len=32, dtype="float32")
VARIANTS = {
    "dense": {},
    "gqa": {"num_kv_heads": 2},
    "window": {"window": 8},
    "gqa+window": {"num_kv_heads": 2, "window": 8},
}


def configs(**overrides):
    kw = dict(BASE, **overrides)
    return jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)


def build(variant="dense", seed=7, **overrides):
    """(JAX cfg, JAX params, port cfg, port module), same weights."""
    jcfg, tcfg = configs(**dict(VARIANTS[variant], **overrides))
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    named = {k: np.asarray(v)
             for k, v in flatten_with_names(jparams)[0].items()}
    module = ttfm.TransformerLM(tcfg)
    module.load_state_dict(ttfm.params_from_jax(named))
    return jcfg, jparams, tcfg, module


def tokens(b, t, seed, vocab=BASE["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)
                                               ).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


def assert_margins(jcfg, jparams, seq, tp):
    """Top-2 margin of the JAX full-forward logits that choose each
    generated token of ``seq`` [B, T] (prompt length ``tp``)."""
    logits = np.asarray(jtfm.forward(jparams, jnp.asarray(seq), jcfg))
    chosen = logits[:, tp - 1:-1]
    top2 = np.sort(chosen, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    assert margin > MARGIN, (
        "top-2 margin %.3g too small for token equality to mean "
        "anything; pick another seed" % margin)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_jax(variant):
    jcfg, jparams, tcfg, module = build(variant)
    toks = tokens(2, 16, seed=1)
    want = jtfm.forward(jparams, jnp.asarray(toks), jcfg)
    got = ttfm.forward(module, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 128)
    close(got, want)
    hidden, aux = ttfm.forward_hidden(module, torch.from_numpy(toks), tcfg)
    want_hidden, want_aux = jtfm.forward_hidden(jparams, jnp.asarray(toks),
                                                jcfg)
    close(hidden, want_hidden)
    assert float(aux) == float(want_aux) == 0.0


def test_forward_matches_jax_through_its_flash_kernel(monkeypatch):
    """With ELASTICDL_FLASH=interpret the JAX transformer's attention is
    the Pallas kernel (head_dim 64, T=128): the port's logits match it."""
    monkeypatch.setenv("ELASTICDL_FLASH", "interpret")
    jcfg, jparams, tcfg, module = build(
        dim=128, num_heads=2, max_seq_len=128)
    toks = tokens(2, 128, seed=2)
    want = jtfm.forward(jparams, jnp.asarray(toks), jcfg)
    close(ttfm.forward(module, torch.from_numpy(toks), tcfg), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    """Prefill logits and caches, then each teacher-forced decode step's
    logits and cache row."""
    jcfg, jparams, tcfg, module = build(variant)
    seq = tokens(2, 10, seed=3)
    tp, max_len = 5, 10
    jl, jcaches = jtfm.prefill(jparams, jcfg, jnp.asarray(seq[:, :tp]),
                               max_len)
    with torch.no_grad():
        tl, tcaches = ttfm.prefill(module, tcfg,
                                   torch.from_numpy(seq[:, :tp]), max_len)
        close(tl, jl)
        for got, want in zip(tcaches, jcaches):
            assert tuple(got.shape) == want.shape == (
                2, 2, max_len, tcfg.kv_heads, 16)
            close(got, want)
        for pos in range(tp, max_len):
            tok = seq[:, pos]
            jl, jcaches = jtfm.decode_step(jparams, jcfg, jcaches, pos,
                                           jnp.asarray(tok))
            tl, tcaches = ttfm.decode_step(module, tcfg, tcaches, pos,
                                           torch.from_numpy(tok))
            close(tl, jl)
        for got, want in zip(tcaches, jcaches):
            close(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    jcfg, jparams, tcfg, module = build(variant, seed=11)
    prompt = tokens(2, 5, seed=8)
    want = np.asarray(jtfm.generate(jparams, jcfg, prompt, 6))
    assert_margins(jcfg, jparams, want, 5)
    got = ttfm.generate(module, tcfg, prompt, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, :5], prompt)


def test_generate_edge_cases():
    jcfg, jparams, tcfg, module = build()
    prompt = tokens(2, 3, seed=11)
    np.testing.assert_array_equal(
        ttfm.generate(module, tcfg, prompt, 0).numpy(), prompt)
    out = ttfm.generate(module, tcfg, prompt, 1).numpy()
    logits = jtfm.forward(jparams, jnp.asarray(prompt), jcfg)[:, -1]
    np.testing.assert_array_equal(out[:, -1],
                                  np.asarray(jnp.argmax(logits, axis=-1)))
    with pytest.raises(ValueError, match="BOS"):
        ttfm.generate(module, tcfg, np.zeros((2, 0), np.int32), 4)


def test_sampling_reproduces_with_its_seed():
    """The port's random stream is a torch.Generator's, not JAX's: the
    contract is reproduction, the vocab and the kept prompt."""
    _, _, tcfg, module = build()
    prompt = tokens(2, 4, seed=10)
    one = ttfm.generate(module, tcfg, prompt, 5, temperature=0.8, seed=7)
    same = ttfm.generate(module, tcfg, prompt, 5, temperature=0.8, seed=7)
    other = ttfm.generate(module, tcfg, prompt, 5, temperature=0.8,
                          seed=8)
    assert torch.equal(one, same)
    assert not torch.equal(one, other)
    assert one.shape == (2, 9)
    np.testing.assert_array_equal(one.numpy()[:, :4], prompt)
    assert bool(((one >= 0) & (one < tcfg.vocab_size)).all())


def test_params_map_round_trips_bit_exactly():
    jcfg, jparams, tcfg, module = build("gqa")
    named = {k: np.asarray(v)
             for k, v in flatten_with_names(jparams)[0].items()}
    back = ttfm.params_to_jax(module)
    assert sorted(back) == sorted(named)
    for name, value in named.items():
        assert back[name].dtype == value.dtype
        np.testing.assert_array_equal(back[name], value)
    # embed stays [V, E]: the tied head is not transposed away.
    assert back["embed"].shape == (128, 64)
    assert back["layers/wk"].shape == (2, 64, 2 * 16)
    fresh = ttfm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == {
        n: tuple(p.shape) for n, p in module.named_parameters()}


def test_config_and_export_validation(tmp_path):
    with pytest.raises(ValueError, match="num_kv_heads"):
        ttfm.model_spec(vocab_size=64, dim=32, num_heads=4, num_layers=2,
                        seq_len=16, num_kv_heads=3)
    # Pipelining needs a mesh with pp > 1 and sp = 1; otherwise the entry
    # warns and runs the plain forward, as the JAX entry does.
    def mesh(**axes):
        shape = dict(dp=1, pp=1, ep=1, tp=1, sp=1)
        shape.update(axes)
        return types.SimpleNamespace(shape=shape)

    for kwargs in ({}, {"mesh": mesh(pp=2, sp=2)}, {"mesh": mesh(tp=2)}):
        with pytest.warns(UserWarning, match="pipeline_microbatches ignored"):
            ttfm.model_spec(vocab_size=64, dim=32, num_heads=2,
                            num_layers=1, seq_len=16,
                            pipeline_microbatches=2, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttfm.model_spec(vocab_size=64, dim=32, num_heads=2, num_layers=2,
                        seq_len=16, pipeline_microbatches=2,
                        mesh=mesh(pp=2))
    with pytest.raises(ValueError, match="attention_impl"):
        ttfm.model_spec(vocab_size=64, dim=32, num_heads=2, num_layers=1,
                        seq_len=16, attention_impl="ringg")
    # MoE, the remat policies and ulysses are ported (tests/test_torch_moe.py,
    # tests/test_torch_remat_policy.py, tests/test_torch_ring_attention.py)
    for kwargs in ({"moe_experts": 2}, {"remat": "dots"}, {"remat": "attn"},
                   {"attention_impl": "ulysses"}):
        cfg = ttfm.model_spec(vocab_size=64, dim=32, num_heads=2,
                              num_layers=1, seq_len=16, **kwargs).config
        assert all(getattr(cfg, k) == v for k, v in kwargs.items())
    _, _, tcfg, module = build()
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        ttfm.export_generate(str(tmp_path / "a"), module, tcfg,
                             max_new_tokens=30, prompt_len=8)
    with pytest.raises(ValueError, match="temperature"):
        ttfm.export_generate(str(tmp_path / "b"), module, tcfg,
                             max_new_tokens=4, prompt_len=4,
                             temperature=-0.5)


def test_jax_generate_export_serves_the_same_tokens(tmp_path):
    """A JAX ``export_generate`` export: its model.npz loads into the
    port, given the zoo entry and the generate settings, and the port
    answers the JAX servable's greedy tokens."""
    from elasticdl_tpu.serving.loader import load_servable as jax_load

    jcfg, jparams, tcfg, _ = build(seed=11)
    jtfm.export_generate(str(tmp_path), jparams, jcfg, max_new_tokens=6,
                         prompt_len=5, platforms=("cpu",))
    prompt = tokens(3, 5, seed=8)
    want = np.asarray(jax_load(str(tmp_path)).predict(prompt))
    assert_margins(jcfg, jparams, want, 5)
    settings = {"prompt_len": 5, "max_new_tokens": 6, "temperature": 0.0}
    with pytest.raises(ValueError, match="zoo"):
        tloader.load_servable(str(tmp_path), device="cpu",
                              generate=settings)
    model = tloader.load_servable(
        str(tmp_path), device="cpu", generate=settings,
        zoo=("transformer", ttfm.zoo_params(tcfg)))
    got = model.predict(prompt)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/models/lm:predict", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_export_generate_http_round_trip(tmp_path, temperature):
    """Port export -> ModelEndpoint -> HTTP :predict, greedy with an
    array body and sampling with the dict body of prompt and seed."""
    _, _, tcfg, module = build(seed=11)
    manifest = ttfm.export_generate(
        str(tmp_path / "lm"), module, tcfg, max_new_tokens=6,
        prompt_len=5, model_name="lm", temperature=temperature, version=2)
    assert manifest["generate"] == {"prompt_len": 5, "max_new_tokens": 6,
                                    "temperature": temperature}
    prompt = tokens(2, 5, seed=8)
    endpoint = tserver.ModelEndpoint(str(tmp_path / "lm"), device="cpu")
    server = tserver.build_server(endpoint, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        if temperature:
            sig = manifest["input_signature"]
            assert sig == {"prompt": {"shape": [None, 5], "dtype": "int32"},
                           "seed": {"shape": [], "dtype": "int32"}}
            body = {"inputs": {"prompt": prompt.tolist(), "seed": 7}}
            want = ttfm.generate(module, tcfg, prompt, 6,
                                 temperature=temperature, seed=7).numpy()
            code, out = _post(port, body)
            code2, again = _post(port, body)
            assert code == code2 == 200
            assert out["predictions"] == again["predictions"]
            assert _post(port, {"inputs": prompt.tolist()})[0] == 400
        else:
            assert manifest["input_signature"] == {"shape": [None, 5],
                                                   "dtype": "int32"}
            want = ttfm.generate(module, tcfg, prompt, 6).numpy()
            code, out = _post(port, {"instances": prompt.tolist()})
            assert code == 200
            assert _post(port, {"instances": tokens(2, 4, 1).tolist()}
                         )[0] == 400
        assert out["model_version"] == 2
        np.testing.assert_array_equal(np.asarray(out["predictions"]), want)
        np.testing.assert_array_equal(np.asarray(out["predictions"])[:, :5],
                                      prompt)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_dataclass_fields_match_jax():
    """The port's config carries the JAX config's fields and defaults."""
    jfields = {f.name: f.default for f in
               dataclasses.fields(jtfm.TransformerConfig)}
    tfields = {f.name: f.default for f in
               dataclasses.fields(ttfm.TransformerConfig)}
    assert tfields == jfields
