"""The port's SPMD trainer over a mesh of dp and sp
(elasticdl_tpu_torch/parallel/spmd_trainer.py, with the transformer's
mesh path and ring attention) against the JAX package's ``SPMDTrainer``
on the same mesh shape, on the CPU.

A small LM (vocab 64, dim 32, 2 heads, 2 layers, T 16, float32; the
config of tests/test_spmd_checkpoint.py) starts from the JAX package's
init, loaded into the port by name, and takes two Adam steps on one
batch in both packages: at sp=2, and at dp=2 x sp=2.  The port's ranks
are spawned gloo processes on the CPU (one thread each, joined under a
time limit); the JAX trainer runs on virtual CPU devices.  Held: the
losses (rtol 1e-4, test_spmd_checkpoint.py's), the parameters (1e-4
abs/rel: two Adam steps of gradients that agree to the reference's 1e-4)
and the Adam moments (1e-4 x each slot's largest entry, plus 1e-4
relative); the count exactly.  Also: each rank's logits equal the
whole-sequence forward's block (RoPE positions offset by the rank), the
labels shift across shards, and checkpoints move between the packages
across mesh layouts with the same loss, before and after one more step
(rtol 1e-4).  This module imports JAX only in the test process, inside the
tests.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import launch

CFG = dict(vocab_size=64, dim=32, num_heads=2, num_layers=2, max_seq_len=16,
           dtype="float32")
STEPS = 2
LR = 1e-3
TOL = 1e-4


def tokens():
    return np.random.RandomState(0).randint(0, 64, size=(4, 16)).astype(
        np.int32)


def port_trainer(mesh, named):
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.parallel.spmd_trainer import SPMDTrainer

    cfg = ttfm.TransformerConfig(**CFG)

    def init_fn(device, seed):
        module = ttfm.TransformerLM(cfg, device=device)
        module.load_state_dict(ttfm.params_from_jax(named))
        return module

    def loss_fn(module, batch):
        toks, targets = batch
        logits = ttfm.forward(module, toks, cfg, mesh=mesh)
        return ttfm.next_token_loss_sum(logits, targets), (targets >= 0).sum()

    return SPMDTrainer(
        mesh, init_fn, loss_fn,
        lambda named_params: torch.optim.Adam(named_params, lr=LR),
        param_specs=ttfm.param_specs(cfg), batch_spec=("dp", "sp"))


def loss_and_next(trainer, batch):
    """The loss, and the loss after one more step: it moves with the
    optimizer state (Adam's moments and count), not the parameters
    alone."""
    loss = float(trainer.eval_loss(batch))
    trainer.train_step(batch)
    return loss, float(trainer.eval_loss(batch))


def rank_train(dp, sp, named, toks, ckpt_in, ckpt_out):
    """One rank: two steps, then the checkpoint legs, then the shard
    checks.  Returns rank 0's state and every rank's readings."""
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        _opt_state_to_jax)

    mesh = build_mesh(dp=dp, sp=sp, backend="gloo", device="cpu")
    trainer = port_trainer(mesh, named)
    batch = (toks, ttfm.next_token_targets(toks))
    out = {"coords": mesh.coords,
           "losses": [float(trainer.train_step(batch))
                      for _ in range(STEPS)]}
    host = lambda t: t.detach().numpy().copy()  # noqa: E731
    out["params"] = {n.replace(".", "/"): host(p)
                     for n, p in trainer.module.named_parameters()}
    out["opt"] = _opt_state_to_jax(
        trainer.optimizer,
        [(n.replace(".", "/"), p) for n, p in
         trainer.module.named_parameters()], host)
    if ckpt_out:
        trainer.save_checkpoint(CheckpointSaver(ckpt_out))
        out["saved"] = loss_and_next(trainer, batch)
    if ckpt_in:
        fresh = port_trainer(mesh, named)
        version = fresh.restore_checkpoint(CheckpointSaver(ckpt_in))
        out["restored"] = (version,) + loss_and_next(fresh, batch)

    # The shard's logits against the whole sequence's (positions offset by
    # the rank), and its targets against the global shift.
    cfg = trainer.module.cfg
    tl, bl = toks.shape[1] // sp, toks.shape[0] // dp
    d, s = mesh.coords["dp"], mesh.coords["sp"]
    rows = (slice(d * bl, (d + 1) * bl), slice(s * tl, (s + 1) * tl))
    shard_toks, shard_targets = trainer.put_batch(batch)
    with torch.no_grad():
        mine = ttfm.forward(trainer.module, shard_toks, cfg, mesh=mesh)
        whole = ttfm.forward(trainer.module, torch.from_numpy(toks).long(),
                             cfg)
    out["logits_gap"] = float((mine - whole[rows]).abs().max())
    out["positions"] = ttfm._positions(shard_toks, mesh).tolist()
    out["targets"] = shard_targets.numpy()
    return out


def jax_trainer(dp, sp, tp=1):
    import jax
    import optax
    from jax.sharding import PartitionSpec as P

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.parallel.spmd_trainer import SPMDTrainer

    cfg = tfm.TransformerConfig(**CFG)
    mesh = build_mesh(dp=dp, sp=sp, tp=tp,
                      devices=jax.devices()[:dp * sp * tp])

    def loss_fn(params, batch):
        toks, _ = batch
        logits = tfm.forward(params, toks, cfg, mesh=mesh)
        return tfm.next_token_loss(logits, toks).mean()

    return SPMDTrainer(mesh, init_fn=lambda rng: tfm.init_params(rng, cfg),
                       loss_fn=loss_fn, optimizer=optax.adam(LR),
                       param_specs=tfm.param_specs(cfg),
                       batch_spec=P("dp", "sp"), rng_seed=4)


def jax_state(trainer):
    from elasticdl_tpu.utils.pytree import flatten_with_names, to_numpy

    return (flatten_with_names(to_numpy(trainer.params))[0],
            flatten_with_names(to_numpy(trainer.opt_state))[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs: JAX at sp=2 and at dp=2 x sp=2 (the latter
    saves a checkpoint after its two steps), the port in the same two
    worlds (sp=2 restores the JAX checkpoint and saves its own), then the
    JAX trainer at dp=2 x tp=2 restoring the port's."""
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver

    toks = tokens()
    jax_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    out = {"jax": {}, "port": {}}
    named = None
    for name, (dp, sp) in (("sp2", (1, 2)), ("dp2_sp2", (2, 2))):
        trainer = jax_trainer(dp, sp)
        if named is None:
            named = jax_state(trainer)[0]
        losses = [float(trainer.train_step((toks, toks)))
                  for _ in range(STEPS)]
        params, opt = jax_state(trainer)
        out["jax"][name] = {"losses": losses, "params": params, "opt": opt}
        if name == "dp2_sp2":
            trainer.save_checkpoint(CheckpointSaver(jax_dir))
            out["jax"]["saved"] = loss_and_next(trainer, (toks, toks))
    out["port"]["sp2"] = launch.spawn(
        rank_train, 2, (1, 2, named, toks, jax_dir, port_dir), threads=1,
        timeout=240)
    out["port"]["dp2_sp2"] = launch.spawn(
        rank_train, 4, (2, 2, named, toks, None, None), threads=1,
        timeout=240)
    restored = jax_trainer(2, 1, tp=2)
    version = restored.restore_checkpoint(CheckpointSaver(port_dir))
    out["jax"]["restored"] = (version,) + loss_and_next(restored,
                                                        (toks, toks))
    return out


@pytest.mark.parametrize("world", ["sp2", "dp2_sp2"])
def test_two_steps_match_the_jax_trainer(runs, world):
    want = runs["jax"][world]
    ranks = runs["port"][world]
    for seen in ranks:
        np.testing.assert_allclose(seen["losses"], want["losses"],
                                   rtol=TOL)
    got = ranks[0]
    assert set(got["params"]) == set(want["params"])
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value, atol=TOL,
                                   rtol=TOL, err_msg=name)
        for other in ranks[1:]:      # replicas stay equal
            np.testing.assert_array_equal(other["params"][name],
                                          got["params"][name])
    assert set(got["opt"]) == set(want["opt"])
    assert int(got["opt"]["0/count"]) == int(want["opt"]["0/count"]) == STEPS
    for name, value in want["opt"].items():
        if name.endswith("count"):
            continue
        np.testing.assert_allclose(
            got["opt"][name], value, rtol=TOL,
            atol=TOL * float(np.abs(value).max()), err_msg=name)


@pytest.mark.parametrize("world", ["sp2", "dp2_sp2"])
def test_rope_offsets_and_cross_shard_labels(runs, world):
    toks = tokens()
    for seen in runs["port"][world]:
        sp = 2
        s, d = seen["coords"]["sp"], seen["coords"]["dp"]
        tl = toks.shape[1] // sp
        bl = toks.shape[0] // (2 if world == "dp2_sp2" else 1)
        assert seen["positions"] == list(range(s * tl, (s + 1) * tl))
        assert seen["logits_gap"] < 2e-5
        want = np.concatenate([toks[:, 1:], np.full((4, 1), -1)], axis=1)
        np.testing.assert_array_equal(
            seen["targets"], want[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl])
        if s == 0:   # the shard's last position predicts the next's first
            np.testing.assert_array_equal(seen["targets"][:, -1],
                                          toks[d * bl:(d + 1) * bl, tl])


def test_checkpoints_move_between_packages_across_layouts(runs):
    # JAX at dp=2 x sp=2 -> the port at sp=2
    loss, next_loss = runs["jax"]["saved"]
    for seen in runs["port"]["sp2"]:
        version, got_loss, got_next = seen["restored"]
        assert version == STEPS
        np.testing.assert_allclose(got_loss, loss, rtol=TOL)
        np.testing.assert_allclose(got_next, next_loss, rtol=TOL)
    # the port at sp=2 -> JAX at dp=2 x tp=2
    loss, next_loss = runs["port"]["sp2"][0]["saved"]
    version, got_loss, got_next = runs["jax"]["restored"]
    assert version == STEPS
    np.testing.assert_allclose(got_loss, loss, rtol=TOL)
    np.testing.assert_allclose(got_next, next_loss, rtol=TOL)


@pytest.mark.parametrize("moe", [0, 2])
def test_param_specs_and_shard_params(moe):
    """``param_specs`` is the JAX PartitionSpec tree by parameter name;
    ``shard_params`` gives a rank the block of each parameter that the
    JAX ``NamedSharding`` puts on the device at the rank's coordinates,
    for every layout of 4 ranks and every rank of it."""
    import types

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from elasticdl_tpu.models import transformer as tfm
    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.utils.pytree import flatten_with_names
    from elasticdl_tpu_torch.models import transformer as ttfm
    from elasticdl_tpu_torch.parallel.mesh import AXES

    cfg = dict(CFG, moe_experts=moe)
    jcfg = tfm.TransformerConfig(**cfg)
    leaves = jax.tree_util.tree_flatten_with_path(
        tfm.param_specs(jcfg), is_leaf=lambda x: isinstance(x, P))[0]
    jspecs = {".".join(str(k.key) for k in path): tuple(spec)
              for path, spec in leaves}
    tcfg = ttfm.TransformerConfig(**cfg)
    assert ttfm.param_specs(tcfg) == jspecs
    named = flatten_with_names(tfm.init_params(jax.random.PRNGKey(0),
                                               jcfg))[0]
    for axes in ({"dp": 4}, {"tp": 2, "sp": 2}, {"pp": 2, "tp": 2},
                 {"ep": 2, "tp": 2}, {"dp": 2, "pp": 2}):
        jmesh = build_mesh(**axes, devices=jax.devices()[:4])
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        shards = {}
        for name, value in named.items():
            placed = jax.device_put(value, NamedSharding(
                jmesh, P(*jspecs[name.replace("/", ".")])))
            shards[name] = {s.device.id: np.asarray(s.data)
                            for s in placed.addressable_shards}
        for rank in range(4):
            where = np.argwhere(ids == rank)[0]
            mesh = types.SimpleNamespace(
                shape=dict(jmesh.shape), device=torch.device("cpu"),
                coords={a: int(i) for a, i in zip(AXES, where)})
            module = ttfm.TransformerLM(tcfg)
            module.load_state_dict(ttfm.params_from_jax(named))
            assert ttfm.shard_params(module, mesh, tcfg) is module
            got = ttfm.params_to_jax(module)
            assert sorted(got) == sorted(named)
            for name, value in got.items():
                np.testing.assert_array_equal(
                    value, shards[name][rank],
                    err_msg="%s %s rank %d" % (axes, name, rank))
