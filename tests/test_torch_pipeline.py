"""Microbatch pipeline parallelism in the port (elasticdl_tpu_torch/
parallel/pipeline.py and the transformer's ``forward_pipelined``, the
zoo entry's ``mesh=`` / ``pipeline_microbatches=``) against the JAX
package, on the CPU.

The twins of tests/test_pipeline.py's 8 tests (12 cases): the pipeline is
semantically invisible, with the same outputs, losses and gradients as
the whole layer stack run in one process, at the reference's tolerances
(forward 1e-5; gradients 1e-4 / 1e-5; the transformer's loss 1e-5 and
gradients 5e-4 / 1e-5; the MoE aux 1e-4 and its gradients 5e-4 / 1e-6).
Also the twins of tests/test_transformer.py's chunked loss on the
pipelined path (:265) and its 4-axis train step (:362).  The JAX side
runs as its own tests run it, on 8 virtual CPU devices.  The port's
ranks are two spawned worlds of gloo processes (one thread each, joined
under a time limit): 4 ranks for every layout of 4 or fewer, and 8 for
pp=8 and the 4-axis step; each runs its jobs in turn, each on a mesh of
its own.  A JAX mesh of 8 devices is run by the port at 4 ranks where
that holds the same axes (dp=2 x pp=4 becomes dp=2 x pp=2).  Each
rank's stage gets its slice of the stack (``spmd_trainer.block``);
gradients are gathered over the stages to be held whole.  This module imports JAX
only in the test process, inside the tests.
"""

import types

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import launch

L, E = 8, 16  # stacked layers, width
TF_TOL = (5e-4, 1e-5)
MOE_TOL = (5e-4, 1e-6)
TF = dict(vocab_size=128, dim=32, num_heads=4, num_layers=4,
          max_seq_len=16, dtype="float32")
TF_VARIANTS = {"dense": {}, "gqa+window": {"num_kv_heads": 2, "window": 8}}
MOE_AUX = dict(TF, moe_experts=4, moe_top_k=2)
MOE_GRAD = dict(MOE_AUX, vocab_size=64, max_seq_len=8)
FOUR_AXIS = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
                 max_seq_len=32, dtype="float32")
CHUNK = dict(vocab_size=64, dim=32, num_heads=2, num_layers=2, seq_len=16,
             dtype="float32")


def make_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(L, E, E) * 0.3).astype(np.float32),
            "b": (rng.randn(L, E) * 0.1).astype(np.float32)}


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_named(cfg, seed):
    import jax

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.utils.pytree import flatten_with_names, to_numpy

    return flatten_with_names(to_numpy(tfm.init_params(
        jax.random.PRNGKey(seed), tfm.TransformerConfig(**cfg))))[0]


# -- rank side -----------------------------------------------------------------


def _mesh(axes):
    from elasticdl_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(**axes, backend="gloo", device="cpu")


def _dp_rows(a, mesh):
    n = a.shape[0] // mesh.shape["dp"]
    return a[mesh.coords["dp"] * n:(mesh.coords["dp"] + 1) * n]


def toy_stage(params, x):
    """This stage's slice of the stack: tanh(x @ w + b) per layer."""
    for i in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][i] + params["b"][i])
    return x


def toy_pipeline(params, x, axes, mb, remat=False, target=None):
    """The toy stack through the pipeline: this rank's rows of y, and with
    ``target`` the whole gradients of the mean squared error (rank 0)."""
    from elasticdl_tpu_torch.parallel import pipeline
    from elasticdl_tpu_torch.parallel.spmd_trainer import block, gather_block

    mesh = _mesh(axes)
    stage = {k: block(torch.from_numpy(v), ("pp",), mesh).clone()
             .requires_grad_() for k, v in params.items()}
    xm = pipeline.split_microbatches(torch.from_numpy(_dp_rows(x, mesh)), mb)
    y = pipeline.merge_microbatches(pipeline.pipeline_apply(
        toy_stage, stage, xm, mesh=mesh, num_microbatches=mb, remat=remat))
    out = {"coords": mesh.coords, "y": y.detach().numpy()}
    if target is not None:
        # Every rank computes the same loss: its share is 1/world of it.
        loss = ((y - torch.from_numpy(target)) ** 2).mean()
        (loss / torch.distributed.get_world_size()).backward()
        out["grads"] = {k: gather_block(v.grad, ("pp",), mesh).numpy()
                        for k, v in stage.items()}
    return out


def _trainer(cfg, named, mesh, loss_of, optimizer=None):
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.parallel.spmd_trainer import SPMDTrainer

    def init_fn(device, seed):
        module = ttfm.TransformerLM(cfg)
        module.load_state_dict(ttfm.params_from_jax(named))
        return ttfm.shard_params(module, mesh, cfg)

    return SPMDTrainer(
        mesh, init_fn, loss_of, optimizer or (
            lambda ps: torch.optim.Adam(ps, lr=1e-3)),
        param_specs=ttfm.param_specs(cfg))


def _full_grads(trainer):
    from elasticdl_tpu_torch.models.spec import jax_name
    from elasticdl_tpu_torch.parallel.spmd_trainer import gather_block

    return {jax_name(n): gather_block(p.grad, trainer._specs[n],
                                      trainer.mesh).numpy()
            for n, p in trainer.module.named_parameters()}


def pipelined_lm(cfg_kw, named, toks, axes, mb, aux_weight, mbs_aux=()):
    """forward_pipelined's loss (+ aux_weight x the aux) and whole
    gradients (rank 0), this rank's logits, and the aux at each of
    ``mbs_aux`` microbatch counts."""
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(**cfg_kw)
    mesh = _mesh(axes)

    def loss_of(module, batch):
        rows, targets = batch
        logits, aux = ttfm.forward_pipelined(module, rows, cfg, mesh, mb,
                                             return_aux=True)
        count = (targets >= 0).sum()
        return (ttfm.next_token_loss_sum(logits, targets)
                + aux_weight * aux * count), count

    trainer = _trainer(cfg, named, mesh, loss_of)
    toks = torch.from_numpy(toks).long()
    batch = (toks, ttfm.next_token_targets(toks))
    loss = float(trainer.compute_gradients(batch))
    grads = _full_grads(trainer)
    rows = trainer.put_batch(batch)[0]
    with torch.no_grad():
        logits, aux = ttfm.forward_pipelined(trainer.module, rows, cfg, mesh,
                                             mb, return_aux=True)
        auxes = {m: float(ttfm.forward_pipelined(
            trainer.module, rows, cfg, mesh, m, return_aux=True)[1])
            for m in mbs_aux}
    return {"coords": mesh.coords, "loss": loss, "logits": logits.numpy(),
            "aux": float(aux), "auxes": auxes,
            "grads": grads if torch.distributed.get_rank() == 0 else None}


def chunked_spec(named, toks, axes):
    """The zoo entry over a pp mesh with pipelining, dense and chunked
    loss, on the JAX parameters: each rank's per-example losses of its
    rows."""
    import warnings

    from elasticdl_tpu_torch.models import transformer as ttfm

    mesh = _mesh(axes)
    rows = torch.from_numpy(_dp_rows(toks, mesh)).long()
    out = {"coords": mesh.coords}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name, extra in (("dense", {}), ("chunked", {"xent_chunk": 8})):
            spec = ttfm.model_spec(**CHUNK, mesh=mesh,
                                   pipeline_microbatches=2, **extra)
            module = ttfm.TransformerLM(spec.config)
            module.load_state_dict(ttfm.params_from_jax(named))
            module = ttfm.shard_params(module, mesh, spec.config)
            with torch.no_grad():
                out[name] = spec.loss_fn(spec.apply_fn(module, rows, True),
                                         rows).numpy()
    return out


def four_axis(named, toks, axes, steps):
    """The 4-axis train step: AdamW over dp x pp x tp x sp; the losses."""
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(**FOUR_AXIS)
    mesh = _mesh(axes)

    def loss_of(module, batch):
        rows, targets = batch
        logits = ttfm.forward(module, rows, cfg, mesh=mesh)
        return ttfm.next_token_loss_sum(logits, targets), (targets >= 0).sum()

    trainer = _trainer(cfg, named, mesh, loss_of, lambda ps: torch.optim.AdamW(
        ps, lr=1e-3, weight_decay=1e-4))
    toks = torch.from_numpy(toks).long()
    batch = (toks, ttfm.next_token_targets(toks))
    return {"losses": [float(trainer.train_step(batch))
                       for _ in range(steps)]}


def rank_jobs(jobs):
    return [globals()[name](*args) for name, args in jobs]


# -- the worlds -------------------------------------------------------------------


def _run(world_size, jobs):
    index = {key: i for i, (key, _) in enumerate(jobs)}
    ranks = launch.spawn(rank_jobs, world_size,
                         ([job for _, job in jobs],), threads=1, timeout=600)
    return {key: [r[i] for r in ranks] for key, i in index.items()}


@pytest.fixture(scope="module")
def world4():
    params = make_params()
    jobs = [
        (("forward", 2, 4), ("toy_pipeline", (
            params, randn(1, 16, E), dict(dp=2, pp=2), 4))),
        (("forward", 4, 8), ("toy_pipeline", (
            params, randn(1, 16, E), dict(pp=4), 8))),
        ("single", ("toy_pipeline", (
            params, np.ones((4, E), np.float32), dict(dp=2, pp=2), 1))),
        ("dp_axis", ("toy_pipeline", (
            params, randn(4, 16, E), dict(dp=2, pp=2), 4))),
    ]
    for remat in (False, True):
        jobs.append((("grads", remat), ("toy_pipeline", (
            params, randn(2, 16, E), dict(pp=4), 8, remat,
            randn(3, 16, E)))))
    for name, extra in TF_VARIANTS.items():
        cfg = dict(TF, **extra)
        jobs.append((("tf", name), ("pipelined_lm", (
            cfg, jax_named(cfg, 0), lm_tokens(5, 8, 16, 128),
            dict(dp=2, pp=2), 4, 0.0))))
    jobs.append(("moe_aux", ("pipelined_lm", (
        MOE_AUX, jax_named(MOE_AUX, 7), lm_tokens(7, 8, 16, 128),
        dict(dp=2, pp=2), 4, 0.0, (2,)))))
    jobs.append(("moe_grads", ("pipelined_lm", (
        MOE_GRAD, jax_named(MOE_GRAD, 9), lm_tokens(9, 8, 8, 64),
        dict(dp=2, pp=2), 4, 0.01))))
    chunk_cfg = dict(CHUNK)
    chunk_cfg["max_seq_len"] = chunk_cfg.pop("seq_len")
    jobs.append(("chunked", ("chunked_spec", (
        jax_named(chunk_cfg, 0), chunk_tokens(), dict(dp=2, pp=2)))))
    return _run(4, jobs)


@pytest.fixture(scope="module")
def world8():
    jobs = [
        (("forward", 8, 8), ("toy_pipeline", (
            make_params(), randn(1, 16, E), dict(pp=8), 8))),
        ("four_axis", ("four_axis", (
            jax_named(FOUR_AXIS, 0), four_axis_tokens(),
            dict(dp=1, pp=2, tp=2, sp=2), 4))),
    ]
    return _run(8, jobs)


def lm_tokens(seed, b, t, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)).astype(
        np.int32)


def chunk_tokens():
    return np.random.RandomState(5).randint(0, 64, size=(4, 16)).astype(
        np.int32)


def four_axis_tokens():
    return np.random.RandomState(0).randint(0, 128, size=(4, 32)).astype(
        np.int32)


# -- the JAX side ---------------------------------------------------------------


def sequential_apply(params, x):
    import jax
    import jax.numpy as jnp

    def body(x, wb):
        w, b = wb
        return jnp.tanh(x @ w + b), None

    y, _ = jax.lax.scan(body, jnp.asarray(x),
                        (jnp.asarray(params["w"]), jnp.asarray(params["b"])))
    return y


def check_rows(ranks, want, rtol, atol):
    for seen in ranks:
        n = seen["y"].shape[0]
        d = seen["coords"]["dp"]
        np.testing.assert_allclose(seen["y"], np.asarray(want)[d * n:(d + 1)
                                                               * n],
                                   rtol=rtol, atol=atol)


# -- tests/test_pipeline.py ---------------------------------------------------------


@pytest.mark.parametrize("pp,mb", [(2, 4), (4, 8), (8, 8)])
def test_forward_parity(world4, world8, pp, mb):
    want = sequential_apply(make_params(), randn(1, 16, E))
    world = world8 if pp == 8 else world4
    check_rows(world[("forward", pp, mb)], want, 1e-5, 1e-5)


def test_single_microbatch_degenerate(world4):
    want = sequential_apply(make_params(), np.ones((4, E), np.float32))
    check_rows(world4["single"], want, 1e-5, 0)


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_parity(world4, remat):
    """Backward through the pipeline (autograd through the ticks and the
    shifts) matches the sequential gradients."""
    import jax
    import jax.numpy as jnp

    x, tgt = randn(2, 16, E), randn(3, 16, E)
    params = {k: jnp.asarray(v) for k, v in make_params().items()}
    want = jax.grad(lambda p: jnp.mean(
        (sequential_apply(p, x) - tgt) ** 2))(params)
    for seen in world4[("grads", remat)]:
        for k in want:
            np.testing.assert_allclose(seen["grads"][k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-5)


def test_pipeline_with_dp_axis(world4):
    """pp composes with dp: each dp rank pipelines its rows."""
    want = sequential_apply(make_params(), randn(4, 16, E))
    check_rows(world4["dp_axis"], want, 1e-5, 1e-5)


def _jax_lm(cfg_kw, seed, toks, aux_weight):
    import jax

    from elasticdl_tpu.models import transformer as tfm

    cfg = tfm.TransformerConfig(**cfg_kw)
    params = tfm.init_params(jax.random.PRNGKey(seed), cfg)

    def loss(p):
        logits, aux = tfm.forward(p, toks, cfg, return_aux=True)
        return (tfm.next_token_loss(logits, toks).mean() + aux_weight * aux,
                (logits, aux))

    (value, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return float(value), grads, np.asarray(logits), float(aux)


def _check_grads(got, grads, tol):
    from elasticdl_tpu.utils.pytree import flatten_with_names

    want = {k: np.asarray(v) for k, v in flatten_with_names(grads)[0].items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=tol[0],
                                   atol=tol[1], err_msg=name)


def _check_logits(ranks, logits, tol):
    for seen in ranks:
        n = seen["logits"].shape[0]
        d = seen["coords"]["dp"]
        np.testing.assert_allclose(seen["logits"], logits[d * n:(d + 1) * n],
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("variant", sorted(TF_VARIANTS))
def test_transformer_pipelined_matches_sequential(world4, variant):
    """The flagship transformer's pipelined forward (dp=2, pp=2, 4
    microbatches) reproduces the single process's loss and gradients,
    GQA and the sliding window riding through the pipeline unchanged."""
    cfg = dict(TF, **TF_VARIANTS[variant])
    value, grads, _, _ = _jax_lm(cfg, 0, lm_tokens(5, 8, 16, 128), 0.0)
    ranks = world4[("tf", variant)]
    for seen in ranks:
        np.testing.assert_allclose(seen["loss"], value, rtol=1e-5)
    _check_grads(ranks[0]["grads"], grads, TF_TOL)


def test_transformer_pipelined_rejects_sp():
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(vocab_size=64, dim=16, num_heads=2,
                                 num_layers=2, dtype="float32")
    module = ttfm.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = types.SimpleNamespace(shape=dict(dp=2, pp=2, ep=1, tp=1, sp=2))
    with pytest.raises(ValueError, match="sp=1"):
        ttfm.forward_pipelined(module, torch.zeros((4, 8), dtype=torch.long),
                               cfg, mesh, 2)


def test_pipelined_moe_aux_matches_sequential(world4):
    """The pipelined path recovers the exact full-batch MoE aux from the
    linear router statistics, at M=4 and at M=2."""
    _, _, logits, aux = _jax_lm(MOE_AUX, 7, lm_tokens(7, 8, 16, 128), 0.0)
    ranks = world4["moe_aux"]
    _check_logits(ranks, logits, MOE_TOL)
    for seen in ranks:
        np.testing.assert_allclose(seen["aux"], aux, rtol=1e-4)
        np.testing.assert_allclose(seen["auxes"][2], aux, rtol=1e-4)


def test_pipelined_moe_grad_parity_through_aux(world4):
    """Gradients of (task loss + 0.01 aux) on the pipelined path match the
    single process's, the router (which only the aux reaches) included."""
    value, grads, _, _ = _jax_lm(MOE_GRAD, 9, lm_tokens(9, 8, 8, 64), 0.01)
    ranks = world4["moe_grads"]
    for seen in ranks:
        np.testing.assert_allclose(seen["loss"], value, rtol=1e-5)
    got = ranks[0]["grads"]
    assert np.abs(got["layers/w_router"]).max() > 0, "router got no gradient"
    _check_grads(got, grads, MOE_TOL)


# -- tests/test_transformer.py's pipelined and 4-axis tests ---------------------------


def test_model_spec_xent_chunk_pipelined_matches_dense(world4):
    """xent_chunk on the pipelined path: the same per-example loss as the
    dense head, and as the JAX entry's (one device: tests/test_pipeline.py
    holds the JAX pipeline to it)."""
    import jax

    from elasticdl_tpu.models import transformer as tfm

    toks = chunk_tokens()
    spec = tfm.model_spec(**CHUNK)
    params = spec.init_fn(jax.random.PRNGKey(0))
    want = np.asarray(spec.loss_fn(spec.apply_fn(params, toks, True), toks))
    for seen in world4["chunked"]:
        np.testing.assert_allclose(seen["chunked"], seen["dense"], rtol=1e-5)
        n = seen["dense"].shape[0]
        d = seen["coords"]["dp"]
        np.testing.assert_allclose(seen["dense"], want[d * n:(d + 1) * n],
                                   rtol=1e-5)


def test_full_4axis_train_step(world8):
    """dp=1 x pp=2 x tp=2 x sp=2: four AdamW steps follow the single
    process's trajectory and learn."""
    import jax
    import optax

    from elasticdl_tpu.models import transformer as tfm

    cfg = tfm.TransformerConfig(**FOUR_AXIS)
    toks = four_axis_tokens()
    tx = optax.adamw(1e-3)
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    opt = tx.init(params)

    @jax.jit
    def step(p, opt):
        value, g = jax.value_and_grad(lambda q: tfm.next_token_loss(
            tfm.forward(q, toks, cfg), toks).mean())(p)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt, value

    want = []
    for _ in range(4):
        params, opt, value = step(params, opt)
        want.append(float(value))
    for seen in world8["four_axis"]:
        losses = seen["losses"]
        assert all(np.isfinite(x) for x in losses)
        assert losses[-1] < losses[0], losses
        np.testing.assert_allclose(losses, want, rtol=1e-4)
