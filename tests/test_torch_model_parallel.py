"""Tensor, expert and sequence parallelism in the port (the ``tp``, ``ep``
and ``sp`` splits of elasticdl_tpu_torch/models/transformer.py, the
SPMD trainer's placement, gradient reduction and checkpoints, LoRA and
Ulysses under a mesh) against the JAX package, on the CPU.

The twins of the mesh tests of tests/test_transformer.py (the sharded
forwards, GQA, Ulysses, the MoE forward, the MoE trainer on an ep mesh,
the sharded trajectory, the aux trained toward balance), of
tests/test_lora.py's LoRA under a mesh, tests/test_ulysses.py's
tp-sharded heads and tests/test_spmd_checkpoint.py's move across layouts,
both ways between the packages.  The JAX side runs as its own tests run
it, on 8 virtual CPU devices; the port's ranks are one spawned world of 4
gloo processes (one thread each, joined under a time limit), which runs
every port job of this module in turn, each on a mesh of its own, from
the JAX package's initial parameters loaded by name.  Port meshes are
the JAX tests' where 4 ranks hold them, and otherwise a 4-rank layout of
the same axes.  Also held: step-1 losses and every gradient leaf of each
layout (the single-process JAX gradients, 5e-4 / 1e-5; MoE 5e-4 / 1e-6,
tests/test_pipeline.py's), and the MoE aux over a data mesh (the global
batch's, 1e-4), which the port's parent took over each rank's rows.
Tolerances are otherwise the reference tests'.  This module imports JAX
only in the test process, inside the tests.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import launch

CFG = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
           max_seq_len=32, dtype="float32")
MOE = dict(CFG, moe_experts=4)
MOE2 = dict(MOE, moe_top_k=2)
CKPT = dict(vocab_size=64, dim=32, num_heads=2, num_layers=2,
            max_seq_len=16, dtype="float32")
LORA = dict(vocab_size=128, dim=32, num_heads=4, num_layers=2,
            max_seq_len=16, dtype="float32")
FWD_TOL = 5e-4
GRAD_TOL = (5e-4, 1e-5)
MOE_GRAD_TOL = (5e-4, 1e-6)
AUX_RTOL = 1e-4

# test_transformer.py:44's layouts -> the port's, at 4 ranks.
SHARDED = {"dp2_tp2_sp2": dict(tp=2, sp=2), "dp1_tp4_sp2": dict(tp=4),
           "dp8": dict(dp=4), "dp1_pp2_tp2_sp2": dict(pp=2, tp=2)}
# Step-1 gradient layouts: (config, JAX params seed, port mesh).
GRAD_LAYOUTS = {
    "tp2_sp2": (CFG, 0, dict(tp=2, sp=2)),
    "pp2_tp2": (CFG, 0, dict(pp=2, tp=2)),
    "dp2_pp2_gqa": (dict(CFG, num_kv_heads=2), 3, dict(dp=2, pp=2)),
    "moe_ep2_tp2": (MOE2, 7, dict(ep=2, tp=2)),
    "moe_ep2_sp2": (MOE2, 7, dict(ep=2, sp=2)),
    "moe_dp4": (MOE2, 7, dict(dp=4)),
}
AUX_WEIGHT = 0.01
# The MoE aux over a data mesh: a router 50x its init's scale routes the
# rows of the batch unevenly, so each rank's own statistic is far from the
# global batch's.
ROUTER_SCALE = 50.0


def make_tokens(b=4, t=32, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)).astype(
        np.int32)


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


def _module(cfg, named, mesh):
    from elasticdl_tpu_torch.models import transformer as ttfm

    module = ttfm.TransformerLM(cfg)
    module.load_state_dict(ttfm.params_from_jax(named))
    return ttfm.shard_params(module, mesh, cfg)


def _rows(a, mesh):
    """This rank's [B/dp, T/sp] block of a global [B, T] array."""
    a = torch.as_tensor(a)
    b, t = a.shape[0] // mesh.shape["dp"], a.shape[1] // mesh.shape["sp"]
    d, s = mesh.coords["dp"], mesh.coords["sp"]
    return a[d * b:(d + 1) * b, s * t:(s + 1) * t]


def port_forward(cfg_kw, named, toks, axes):
    """This rank's logits and aux over the mesh ``axes``."""
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(**cfg_kw)
    mesh = _mesh(axes)
    module = _module(cfg, named, mesh)
    with torch.no_grad():
        logits, aux = ttfm.forward(module, _rows(toks, mesh).long(), cfg,
                                   mesh=mesh, return_aux=True)
    return {"coords": mesh.coords, "logits": logits.numpy(),
            "aux": float(aux)}


def _trainer(cfg, named, mesh, optimizer, aux_weight=AUX_WEIGHT):
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.parallel.spmd_trainer import SPMDTrainer

    def loss_fn(module, batch):
        toks, targets = batch
        logits, aux = ttfm.forward(module, toks, cfg, mesh=mesh,
                                   return_aux=True)
        count = (targets >= 0).sum()
        loss = ttfm.next_token_loss_sum(logits, targets)
        if cfg.moe_experts:
            # Counted once over the mesh: each rank's share of the aux is
            # its share of the terms.
            loss = loss + aux_weight * aux * count
        return loss, count

    return SPMDTrainer(mesh, lambda device, seed: _module(cfg, named, mesh),
                       loss_fn, optimizer,
                       param_specs=ttfm.param_specs(cfg))


def _batch(toks):
    from elasticdl_tpu_torch.models import transformer as ttfm

    toks = torch.from_numpy(toks).long()
    return toks, ttfm.next_token_targets(toks)


def _full_grads(trainer):
    from elasticdl_tpu_torch.models.spec import jax_name
    from elasticdl_tpu_torch.parallel.spmd_trainer import gather_block

    return {jax_name(n): gather_block(p.grad, trainer._specs[n],
                                      trainer.mesh).numpy()
            for n, p in trainer.module.named_parameters()}


def port_step1(cfg_kw, named, toks, axes):
    """Step-1 loss and the whole gradient of every parameter (rank 0)."""
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(**cfg_kw)
    mesh = _mesh(axes)
    trainer = _trainer(cfg, named, mesh,
                       lambda ps: torch.optim.Adam(ps, lr=1e-3))
    loss = float(trainer.compute_gradients(_batch(toks)))
    grads = _full_grads(trainer)
    return {"loss": loss, "grads": grads if torch.distributed.get_rank() == 0
            else None}


def port_train(cfg_kw, named, toks, axes, opt, lr, steps, aux_weight):
    """``steps`` steps; the loss of each and the aux before each."""
    from elasticdl_tpu_torch.models import transformer as ttfm

    cfg = ttfm.TransformerConfig(**cfg_kw)
    mesh = _mesh(axes)
    optimizer = {
        "sgd": lambda ps: torch.optim.SGD(ps, lr=lr),
        "adamw": lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4),
    }[opt]
    trainer = _trainer(cfg, named, mesh, optimizer, aux_weight)
    batch = _batch(toks)
    losses, auxes = [], []
    for _ in range(steps):
        if cfg.moe_experts:
            with torch.no_grad():
                auxes.append(float(ttfm.forward(
                    trainer.module, trainer.put_batch(batch)[0], cfg,
                    mesh=mesh, return_aux=True)[1]))
        losses.append(float(trainer.train_step(batch)))
    return {"losses": losses, "auxes": auxes}


def port_lora(named, toks, axes):
    """The LoRA spec's forward over a mesh, on the JAX base parameters."""
    from elasticdl_tpu_torch.models import lora
    from elasticdl_tpu_torch.models import transformer as ttfm

    mesh = _mesh(axes)
    kw = dict(LORA)
    kw["seq_len"] = kw.pop("max_seq_len")
    spec = lora.model_spec(rank=2, mesh=mesh, **kw)
    module = spec.init_fn("cpu", 0)
    base = ttfm.TransformerLM(spec.config)
    base.load_state_dict(ttfm.params_from_jax(named))
    base = ttfm.shard_params(base, mesh, spec.config)
    with torch.no_grad():
        for name, p in module.base.named_parameters():
            p.copy_(dict(base.named_parameters())[name])
        # A nonzero delta: B = 0 at init would hide a mis-sharded merge.
        for name, p in module.lora.named_parameters():
            p.copy_(torch.from_numpy(np.random.RandomState(3).randn(
                *p.shape).astype(np.float32) * 0.05))
        rows = _rows(toks, mesh).long()
        out = spec.apply_fn(module, rows, False)
        adapters = {n: p.numpy().copy()
                    for n, p in module.lora.named_parameters()}
    return {"coords": mesh.coords, "logits": out.numpy(),
            "adapters": adapters}


def port_ulysses(q, k, v, axes):
    from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = _mesh(axes)
    t, h = q.shape[1] // mesh.shape["sp"], q.shape[2] // mesh.shape["tp"]
    s, i = mesh.coords["sp"], mesh.coords["tp"]
    shard = [torch.from_numpy(a[:, s * t:(s + 1) * t, i * h:(i + 1) * h])
             for a in (q, k, v)]
    return {"coords": mesh.coords,
            "out": ulysses_attention(*shard, mesh, causal=True).numpy()}


def port_checkpoint(named, toks, axes, restore_dir, restore_axes, save_dir):
    """Restore the JAX checkpoint at ``restore_axes`` (its loss, and the
    loss after one more step), then train two steps from ``named`` at
    ``axes`` and save."""
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    cfg = ttfm.TransformerConfig(**CKPT)
    batch = _batch(toks)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    out = {}
    restored = _trainer(cfg, named, _mesh(restore_axes), adam)
    version = restored.restore_checkpoint(CheckpointSaver(restore_dir))
    loss = float(restored.eval_loss(batch))
    restored.train_step(batch)
    out["restored"] = (version, loss, float(restored.eval_loss(batch)))
    trainer = _trainer(cfg, named, _mesh(axes), adam)
    for _ in range(2):
        trainer.train_step(batch)
    trainer.save_checkpoint(CheckpointSaver(save_dir))
    loss = float(trainer.eval_loss(batch))
    trainer.train_step(batch)
    out["saved"] = (trainer.version - 1, loss,
                    float(trainer.eval_loss(batch)))
    return out


def rank_jobs(jobs):
    return [globals()[name](*args) for name, args in jobs]


# -- the world -------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every port job of the module in one world of 4 ranks; the JAX
    checkpoint the port restores is written first."""
    import optax
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.parallel.spmd_trainer import SPMDTrainer
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver

    jax_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    ckpt_toks = make_tokens(4, 16, seed=0, vocab=64)
    jcfg = tfm.TransformerConfig(**CKPT)
    mesh = build_mesh(dp=2, tp=2, sp=2)

    def loss_fn(params, batch):
        tokens, _ = batch
        logits = tfm.forward(params, tokens, jcfg, mesh=mesh)
        return tfm.next_token_loss(logits, tokens).mean()

    jtrainer = SPMDTrainer(
        mesh, init_fn=lambda rng: tfm.init_params(rng, jcfg),
        loss_fn=loss_fn, optimizer=optax.adam(1e-3),
        param_specs=tfm.param_specs(jcfg), batch_spec=P("dp", "sp"),
        rng_seed=4)
    for _ in range(2):
        jtrainer.train_step((ckpt_toks, ckpt_toks))
    jtrainer.save_checkpoint(CheckpointSaver(jax_dir))
    jax_saved = (2, float(jtrainer.eval_loss((ckpt_toks, ckpt_toks))))
    jtrainer.train_step((ckpt_toks, ckpt_toks))
    jax_saved += (float(jtrainer.eval_loss((ckpt_toks, ckpt_toks))),)

    jobs, index = [], {}

    def add(key, name, *args):
        index[key] = len(jobs)
        jobs.append((name, args))

    dense = jax_named(CFG, 0)
    for case, axes in SHARDED.items():
        add(("sharded", case), "port_forward", CFG, dense, make_tokens(),
            axes)
    add("gqa", "port_forward", dict(CFG, num_kv_heads=2),
        jax_named(dict(CFG, num_kv_heads=2), 3), make_tokens(),
        dict(tp=2, sp=2))
    add("ulysses", "port_forward", dict(CFG, attention_impl="ulysses"),
        dense, make_tokens(), dict(tp=2, sp=2))
    moe = jax_named(MOE, 3)
    for axes in (dict(ep=2, tp=2), dict(ep=2, sp=2)):
        add(("moe", tuple(axes)), "port_forward", MOE, moe, make_tokens(),
            axes)
    peaked = jax_named(MOE2, 7)
    peaked["layers/w_router"] = peaked["layers/w_router"] * ROUTER_SCALE
    for axes in (dict(dp=4), dict(dp=2, tp=2)):
        add(("moe_aux_dp", tuple(axes)), "port_forward", MOE2, peaked,
            make_tokens(seed=7), axes)
    for case, (cfg, seed, axes) in GRAD_LAYOUTS.items():
        add(("grads", case), "port_step1", cfg, jax_named(cfg, seed),
            make_tokens(seed=seed), axes)
    add("moe_ep_learns", "port_train", MOE, jax_named(MOE, 0),
        make_tokens(), dict(ep=2, sp=2), "adamw", 2e-3, 4, AUX_WEIGHT)
    add("trajectory", "port_train", CFG, jax_named(CFG, 1), make_tokens(),
        dict(tp=2, sp=2), "sgd", 0.1, 3, AUX_WEIGHT)
    add("aux_balance", "port_train", dict(MOE2, moe_aux_weight=0.5),
        jax_named(MOE2, 0), make_tokens(), dict(ep=2, tp=2), "adamw", 5e-3,
        6, 0.5)
    add("lora", "port_lora", jax_named(LORA, 0), make_tokens(2, 16, 12),
        dict(tp=2, sp=2))
    qkv = ulysses_qkv()
    add("ulysses_tp", "port_ulysses", *qkv, dict(tp=2, sp=2))
    add("checkpoint", "port_checkpoint", jax_named(CKPT, 4), ckpt_toks,
        dict(tp=2, sp=2), jax_dir, dict(pp=2, tp=2), port_dir)

    ranks = launch.spawn(rank_jobs, 4, (jobs,), threads=1, timeout=600)
    out = {key: [r[i] for r in ranks] for key, i in index.items()}
    out["jax_saved"] = jax_saved
    out["port_dir"] = port_dir
    out["ckpt_toks"] = ckpt_toks
    return out


def ulysses_qkv():
    rng = np.random.RandomState(0)
    return tuple(rng.randn(2, 16, 4, 8).astype(np.float32)
                 for _ in range(3))


def jax_params(cfg_kw, seed, router_scale=1.0):
    import jax

    from elasticdl_tpu.models import transformer as tfm

    params = tfm.init_params(jax.random.PRNGKey(seed),
                             tfm.TransformerConfig(**cfg_kw))
    if router_scale != 1.0:
        params["layers"]["w_router"] = (params["layers"]["w_router"]
                                        * router_scale)
    return params


def jax_forward(cfg_kw, seed, toks, mesh=None, router_scale=1.0):
    import jax

    from elasticdl_tpu.models import transformer as tfm

    cfg = tfm.TransformerConfig(**cfg_kw)
    params = jax_params(cfg_kw, seed, router_scale)
    if mesh is not None:
        params = tfm.shard_params(params, mesh, cfg)
    logits, aux = jax.jit(lambda p, t: tfm.forward(
        p, t, cfg, mesh=mesh, return_aux=True))(params, toks)
    return np.asarray(logits), float(aux)


def check_shards(ranks, ref, tol, what):
    for seen in ranks:
        c = seen["coords"]
        got = seen["logits"]
        b, t = got.shape[0], got.shape[1]
        want = ref[c["dp"] * b:(c["dp"] + 1) * b,
                   c["sp"] * t:(c["sp"] + 1) * t]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg="%s at %s" % (what, c))


# -- tests/test_transformer.py's mesh tests ---------------------------------------


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_sharded_forward_matches_single_device(world, case):
    ref, _ = jax_forward(CFG, 0, make_tokens())
    check_shards(world[("sharded", case)], ref, FWD_TOL, case)


def test_gqa_sharded_matches_single_device(world):
    ref, _ = jax_forward(dict(CFG, num_kv_heads=2), 3, make_tokens())
    check_shards(world["gqa"], ref, FWD_TOL, "gqa tp2 sp2")


def test_ulysses_forward_matches_single_device(world):
    ref, _ = jax_forward(dict(CFG, attention_impl="ulysses"), 0,
                         make_tokens())
    check_shards(world["ulysses"], ref, FWD_TOL, "ulysses tp2 sp2")


def test_moe_forward_matches_across_sharding(world):
    """ep with tp, and ep with sp: the dispatch over a shard of the
    sequence counts the earlier shards' tokens and sizes capacity over the
    whole sequence, so it is the single device's exactly."""
    ref, aux = jax_forward(MOE, 3, make_tokens())
    assert np.isfinite(ref).all()
    for axes in (("ep", "tp"), ("ep", "sp")):
        ranks = world[("moe", axes)]
        check_shards(ranks, ref, FWD_TOL, "moe %s" % (axes,))
        for seen in ranks:
            np.testing.assert_allclose(seen["aux"], aux, rtol=AUX_RTOL)


@pytest.fixture(scope="module")
def moe_aux_refs():
    """The peaked-router MoE's logits and aux on one device, and its aux
    under the JAX package's dp=4 mesh (GSPMD's global statistics)."""
    import jax

    from elasticdl_tpu.parallel.mesh import build_mesh

    toks = make_tokens(seed=7)
    ref, aux = jax_forward(MOE2, 7, toks, router_scale=ROUTER_SCALE)
    _, jaux = jax_forward(MOE2, 7, toks, router_scale=ROUTER_SCALE,
                          mesh=build_mesh(dp=4, devices=jax.devices()[:4]))
    return toks, ref, aux, jaux


@pytest.mark.parametrize("axes", [("dp",), ("dp", "tp")])
def test_moe_aux_over_a_data_mesh_is_the_global_batchs(world, moe_aux_refs,
                                                        axes):
    """The router statistics are means over the global batch (summed over
    dp before the product), as GSPMD takes them in the JAX package; a
    rank's own rows give another value."""
    toks, ref, aux, jaux = moe_aux_refs
    np.testing.assert_allclose(jaux, aux, rtol=AUX_RTOL)
    ranks = world[("moe_aux_dp", axes)]
    check_shards(ranks, ref, FWD_TOL, "moe dp")
    rows = 4 // (4 if axes == ("dp",) else 2)
    local = [jax_forward(MOE2, 7, toks[i:i + rows],
                         router_scale=ROUTER_SCALE)[1]
             for i in range(0, 4, rows)]
    for seen in ranks:
        np.testing.assert_allclose(seen["aux"], aux, rtol=AUX_RTOL)
        # The statistic is not linear in the batch: a shard's own differs.
        assert all(abs(seen["aux"] - a) > 10 * AUX_RTOL * aux
                   for a in local)


@pytest.mark.parametrize("layout", sorted(GRAD_LAYOUTS))
def test_step1_gradients_match_single_device(world, layout):
    """Each block's gradient, summed over the ranks that hold it, is the
    single process's: no split counts a gradient twice or not at all."""
    import jax

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.utils.pytree import flatten_with_names

    cfg_kw, seed, _ = GRAD_LAYOUTS[layout]
    cfg = tfm.TransformerConfig(**cfg_kw)
    toks = make_tokens(seed=seed)

    def loss(p):
        logits, aux = tfm.forward(p, toks, cfg, return_aux=True)
        out = tfm.next_token_loss(logits, toks).mean()
        return out + AUX_WEIGHT * aux if cfg.moe_experts else out

    value, grads = jax.jit(jax.value_and_grad(loss))(
        tfm.init_params(jax.random.PRNGKey(seed), cfg))
    want = {k: np.asarray(v) for k, v in flatten_with_names(grads)[0].items()}
    ranks = world[("grads", layout)]
    for seen in ranks:
        np.testing.assert_allclose(seen["loss"], float(value), rtol=1e-5)
    got = ranks[0]["grads"]
    assert sorted(got) == sorted(want)
    rtol, atol = MOE_GRAD_TOL if cfg.moe_experts else GRAD_TOL
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)
    if cfg.moe_experts:
        assert np.abs(got["layers/w_router"]).max() > 0


def jax_trajectory(cfg_kw, seed, toks, tx, steps, aux_weight=AUX_WEIGHT):
    import jax
    import optax

    from elasticdl_tpu.models import transformer as tfm

    cfg = tfm.TransformerConfig(**cfg_kw)

    def loss(p):
        logits, aux = tfm.forward(p, toks, cfg, return_aux=True)
        out = tfm.next_token_loss(logits, toks).mean()
        return out + aux_weight * aux if cfg.moe_experts else out

    @jax.jit
    def step(p, opt):
        value, g = jax.value_and_grad(loss)(p)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt, value

    params = tfm.init_params(jax.random.PRNGKey(seed), cfg)
    opt = tx.init(params)
    out = []
    for _ in range(steps):
        params, opt, value = step(params, opt)
        out.append(float(value))
    return out


def test_moe_ep_train_step_learns(world):
    import optax

    want = jax_trajectory(MOE, 0, make_tokens(),
                          optax.adamw(2e-3, weight_decay=1e-4), 4)
    for seen in world["moe_ep_learns"]:
        losses = seen["losses"]
        assert all(np.isfinite(x) for x in losses)
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_loss_decreases_matches_unsharded_trajectory(world):
    import optax

    want = jax_trajectory(CFG, 1, make_tokens(), optax.sgd(0.1), 3)
    for seen in world["trajectory"]:
        np.testing.assert_allclose(seen["losses"], want, rtol=2e-3)


def test_moe_aux_loss_trains_toward_balance_on_ep_mesh(world):
    import jax

    from elasticdl_tpu.models import transformer as tfm

    cfg = tfm.TransformerConfig(**dict(MOE2, moe_aux_weight=0.5))
    _, aux0 = tfm.forward(tfm.init_params(jax.random.PRNGKey(0), cfg),
                          make_tokens(), cfg, return_aux=True)
    for seen in world["aux_balance"]:
        auxes = seen["auxes"]
        np.testing.assert_allclose(auxes[0], float(aux0), rtol=AUX_RTOL)
        assert np.isfinite(auxes[-1])
        assert auxes[-1] <= auxes[0] + 1e-3, auxes


# -- LoRA, Ulysses, checkpoints -----------------------------------------------------


def test_lora_under_parallel_mesh(world):
    """Merge-at-forward under tp and sp: the adapters replicated, the delta
    added to W's block (tests/test_lora.py:161, with a nonzero delta)."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.models.lora import merge_layers

    cfg = tfm.TransformerConfig(**LORA)
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    ranks = world["lora"]
    adapters = ranks[0]["adapters"]
    lora = {}
    for name, value in adapters.items():
        target, ab = name.split(".")
        lora.setdefault(target, {})[ab] = jnp.asarray(value)
    scaling = 16.0 / 2
    merged = dict(params, layers=merge_layers(params["layers"], lora,
                                              scaling))
    want = np.asarray(tfm.forward(merged, make_tokens(2, 16, 12), cfg))
    for seen in ranks:
        for name, value in adapters.items():
            np.testing.assert_array_equal(seen["adapters"][name], value)
    check_shards(ranks, want, 1e-5, "lora tp2 sp2")


def test_ulysses_with_tp_sharded_heads(world):
    from elasticdl_tpu.parallel.ring_attention import attention_local

    q, k, v = ulysses_qkv()
    ref = np.asarray(attention_local(q, k, v, causal=True))
    for seen in world["ulysses_tp"]:
        c = seen["coords"]
        got = seen["out"]
        t, h = got.shape[1], got.shape[2]
        want = ref[:, c["sp"] * t:(c["sp"] + 1) * t,
                   c["tp"] * h:(c["tp"] + 1) * h]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_spmd_checkpoint_restores_across_mesh_layouts(world):
    """JAX at dp=2 x tp=2 x sp=2 -> the port at pp=2 x tp=2; the port at
    tp=2 x sp=2 -> JAX at dp=2 x tp=4: the same loss, and the same loss
    after one more step (Adam's moments and count moved too)."""
    import optax
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.parallel.spmd_trainer import SPMDTrainer
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver

    version, loss, next_loss = world["jax_saved"]
    for seen in world["checkpoint"]:
        got = seen["restored"]
        assert got[0] == version
        np.testing.assert_allclose(got[1:], (loss, next_loss), rtol=1e-4)
    toks = world["ckpt_toks"]
    jcfg = tfm.TransformerConfig(**CKPT)
    mesh = build_mesh(dp=2, tp=4, sp=1)

    def loss_fn(params, batch):
        tokens, _ = batch
        logits = tfm.forward(params, tokens, jcfg, mesh=mesh)
        return tfm.next_token_loss(logits, tokens).mean()

    trainer = SPMDTrainer(
        mesh, init_fn=lambda rng: tfm.init_params(rng, jcfg),
        loss_fn=loss_fn, optimizer=optax.adam(1e-3),
        param_specs=tfm.param_specs(jcfg), batch_spec=P("dp", "sp"))
    assert trainer.restore_checkpoint(CheckpointSaver(
        world["port_dir"])) == 2
    got_loss = float(trainer.eval_loss((toks, toks)))
    trainer.train_step((toks, toks))
    got_next = float(trainer.eval_loss((toks, toks)))
    saved = world["checkpoint"][0]["saved"]
    assert saved[0] == 2
    np.testing.assert_allclose((got_loss, got_next), saved[1:], rtol=1e-4)


def test_widths_a_split_cannot_divide_are_refused():
    """GSPMD splits any width; the port's tp split needs the heads and the
    K/V heads to divide by tp, and ep the experts, and says which."""
    import types

    from elasticdl_tpu_torch.models import transformer as ttfm

    def mesh(**axes):
        shape = dict(dp=1, pp=1, ep=1, tp=1, sp=1)
        shape.update(axes)
        return types.SimpleNamespace(shape=shape)

    cfg = ttfm.TransformerConfig(**dict(CFG, num_kv_heads=2))
    with pytest.raises(ValueError, match="K/V heads \\(2\\)"):
        ttfm._check_mesh(mesh(tp=4), cfg)
    cfg = ttfm.TransformerConfig(**dict(CFG, num_heads=2))
    with pytest.raises(ValueError, match="num_heads \\(2\\)"):
        ttfm._check_mesh(mesh(tp=4), cfg)
    with pytest.raises(ValueError, match="moe_experts \\(4\\)"):
        ttfm._check_mesh(mesh(ep=8), ttfm.TransformerConfig(**MOE))
    ttfm._check_mesh(mesh(tp=4, ep=4), ttfm.TransformerConfig(**MOE))
