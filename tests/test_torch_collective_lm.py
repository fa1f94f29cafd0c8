"""The flagship LM and LoRA over it on the port's collective path
(worker/collective_trainer.py over a data mesh, the ``--distribution_
strategy collective`` trainer), on a gloo world of two spawned CPU ranks
at batch 4 each, against the JAX package's CollectiveTrainer at the
global batch of 8 (a 2-device CPU mesh) and against the port alone at
batch 8.

Cases: the dense LM with the chunked loss off and on (``xent_chunk`` 0
and 4, where ``apply_fn`` hands a ``("hidden", ...)`` tuple to the loss),
each with remat off and on, the remat policies "dots" and "attn", and
LoRA with ``train_norms`` false (an empty second optimizer group) and
true.  Rank 1 starts from other weights (another seed), so every case
also shows that a rank adopts rank 0's parameters, the frozen LoRA base
included.

Tolerances: against the JAX package, tests/test_torch_transformer_train
.py's (losses 2e-4 relative, gradients 1e-4 relative + 1e-5 absolute:
float32 on both sides, sums in other orders; parameters after an AdamW
step 1e-4 absolute, since the update divides by sqrt(nu)); two ranks
against the port alone at batch 8, losses and gradients 1e-6 relative +
1e-6 absolute (the same float32 operations on the CPU, the batch sums of
the backward split in two halves), parameters after the step 1e-4 as
against the JAX package; ZeRO-1 on against off and the re-forms, bit for
bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.parallel import launch

LOSS_RTOL = 2e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 1e-4
PORT_TOL = dict(rtol=1e-6, atol=1e-6)
LM_KW = dict(vocab_size=128, dim=32, num_heads=4, num_layers=2, seq_len=16,
             dtype="float32", learning_rate=1e-3)
CASES = {
    "dense": ("transformer", {"remat": False}),
    "dense_remat": ("transformer", {"remat": True}),
    "chunked": ("transformer", {"xent_chunk": 4, "remat": False}),
    "chunked_remat": ("transformer", {"xent_chunk": 4, "remat": True}),
    "dots": ("transformer", {"remat": "dots"}),
    "attn": ("transformer", {"remat": "attn"}),
    "lora": ("lora", {"rank": 2, "train_norms": False}),
    "lora_norms": ("lora", {"rank": 2, "train_norms": True}),
    # Flagship-MoE at test size: the router's load-balance aux is taken
    # over the global batch, so each rank's statistics are summed over
    # the world before the product.
    "moe": ("transformer", {"moe_experts": 4, "moe_top_k": 2,
                            "remat": False}),
}
# The cases that also run ZeRO-1, re-form and checkpoint.
ZERO_CASES = ("dense_remat", "lora", "lora_norms")
BATCH = 4
STEPS = 3
RANKS_TIMEOUT_S = 300


def port_spec(case):
    zoo, kw = CASES[case]
    if zoo == "lora":
        from elasticdl_tpu_torch.models import lora
        return lora.model_spec(**kw, **LM_KW)
    from elasticdl_tpu_torch.models import transformer
    return transformer.model_spec(**kw, **LM_KW)


def jax_spec(case):
    zoo, kw = CASES[case]
    if zoo == "lora":
        from elasticdl_tpu.models import lora
        return lora.model_spec(**kw, **LM_KW)
    from elasticdl_tpu.models import transformer
    return transformer.model_spec(**kw, **LM_KW)


def port_trainer(case, batch_size=BATCH, **kwargs):
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    return CollectiveTrainer(port_spec(case), batch_size=batch_size,
                             device="cpu", **kwargs)


def global_batches(seed=40):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, LM_KW["vocab_size"], size=(2 * BATCH,
                                                      LM_KW["seq_len"])
                        ).astype(np.int32) for _ in range(STEPS + 1)]


def host(t):
    return t.detach().cpu().numpy().copy()


def whole(trainer):
    """Host copies of the whole optimizer state (a collective under
    ZeRO-1 in a world: every member calls it together)."""
    return {k: (host(v) if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in trainer._whole_state().items()}


def same(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def grads_of(trainer):
    from elasticdl_tpu_torch.models.spec import jax_name

    return {jax_name(n): host(p.grad) for n, p in
            trainer.module.named_parameters() if p.grad is not None}


def groups_of(optimizer):
    """Each group's hyper-parameters and parameter count."""
    return [(g.get("jax_prefix"), g["lr"], g["weight_decay"], g["betas"],
             g["eps"], len(g["params"])) for g in optimizer.param_groups]


# -- the world of two ranks ----------------------------------------------------


def world_of_two(batches, ckpt_dir):
    """Every case on one world of two ranks, in one spawn: rank r trains
    on rows [4r, 4r + 4) of each global batch; rank 1's trainers start
    from seed 1, rank 0's from seed 0."""
    from elasticdl_tpu_torch.parallel.mesh import data_mesh
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    rank = dist.get_rank()

    def mesh():
        return data_mesh(backend="gloo", device="cpu")

    def mine(i):
        rows = batches[i][rank * BATCH:(rank + 1) * BATCH]
        return rows, rows

    def run(t, steps, start=0):
        return [float(t.train_minibatch(*mine(start + i))[0])
                for i in range(steps)]

    out = {}
    for case in CASES:
        r = out[case] = {}
        off = port_trainer(case, rng_seed=rank)
        r["own_init"] = off.export_parameters()
        off.rebuild(mesh())
        r["adopted"] = off.export_parameters()
        r["losses"] = run(off, 1)
        r["grads"] = grads_of(off)
        r["step1_params"] = off.export_parameters()
        if case not in ZERO_CASES:
            continue
        r["losses"] += run(off, STEPS - 1, start=1)
        r["state"] = whole(off)
        r["params"] = off.export_parameters()
        z1 = port_trainer(case, mesh=mesh(), zero1=True, rng_seed=rank)
        r["z1_losses"] = run(z1, STEPS)
        r["z1_state"] = whole(z1)
        r["z1_params"] = z1.export_parameters()
        r["z1_report"] = z1.zero1_report()
        r["off_report"] = off.zero1_report()
        r["z1_groups"] = (groups_of(z1._optimizer), groups_of(z1._shard_opt))
        r["z1_shard_entries"] = len(z1._optimizer.state)
        del z1
        # 2 -> 1 -> 2: rank 0 alone for a step, then both again.
        kept = r["state"]
        off.snapshot_to_host()
        if rank == 0:
            off.rebuild(None)
            r["alone_kept"] = same(whole(off), kept)
            r["alone_loss"] = float(off.train_minibatch(*mine(STEPS))[0])
            r["alone_state"] = whole(off)
        off.rebuild(mesh())
        r["regrown_state"] = whole(off)
        r["regrown_params"] = off.export_parameters()
        r["regrown_version"] = off.version
    # A ZeRO-1 LoRA checkpoint written by rank 0 at version 2; every rank
    # joins the cadence's gather.
    z1 = port_trainer("lora_norms", mesh=mesh(), zero1=True, rng_seed=rank,
                      checkpoint_saver=CheckpointSaver(ckpt_dir),
                      checkpoint_steps=2, checkpoint_writer=rank == 0)
    out["ckpt_losses"] = run(z1, 2)
    z1.flush_checkpoints()
    out["ckpt_state"] = whole(z1)
    out["ckpt_losses"] += run(z1, STEPS - 2, start=2)
    out["ckpt_params"] = z1.export_parameters()
    return out


@pytest.fixture(scope="module")
def data():
    return global_batches()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lora_z1"))


@pytest.fixture(scope="module")
def world(data, ckpt_dir):
    return launch.spawn(world_of_two, 2, (data, ckpt_dir), threads=1,
                        timeout=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def single(data):
    """The port alone at batch 8 from rank 0's init: step-1 loss,
    gradients and parameters after the step, per case."""
    out = {}
    for case in CASES:
        t = port_trainer(case, batch_size=2 * BATCH, rng_seed=0)
        loss = float(t.train_minibatch(data[0], data[0])[0])
        out[case] = (loss, grads_of(t), t.export_parameters())
    return out


def jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), axis_names=("data",))


def jax_trainer(case, named, **kwargs):
    """The JAX CollectiveTrainer on a 2-device CPU mesh at 4 a device
    (the global batch of 8), from ``named`` (None: its own init)."""
    from elasticdl_tpu.utils.pytree import to_numpy, unflatten_from_names
    from elasticdl_tpu.worker.collective_trainer import CollectiveTrainer

    trainer = CollectiveTrainer(jax_spec(case), batch_size=BATCH,
                                mesh=jax_mesh(), **kwargs)
    if named is not None:
        trainer.set_params(unflatten_from_names(to_numpy(trainer.params),
                                                named))
    return trainer


@pytest.fixture(scope="module")
def jax_refs(data, world):
    """Per case, from rank 0's init: the JAX trainer's step-1 loss and
    gradients at the global batch (its own ``_loss_and_grads``: the
    masked mean over the 8 rows), then its parameters after one AdamW
    step."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.utils.pytree import flatten_with_names

    out = {}
    for case in CASES:
        trainer = jax_trainer(case, world[0][case]["own_init"])
        loss, grads = jax.jit(trainer._loss_and_grads)(
            trainer.params, jnp.asarray(data[0]), jnp.asarray(data[0]),
            jnp.ones(2 * BATCH, jnp.float32))
        grads = {k: np.asarray(v)
                 for k, v in flatten_with_names(grads)[0].items()}
        step_loss = float(trainer.train_minibatch(data[0], data[0])[0])
        out[case] = (float(loss), grads, step_loss,
                     trainer.export_parameters())
    return out


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_the_jax_collective_trainer(world, jax_refs, case):
    """Step-1 loss and gradients of the world (each rank's local weighted
    loss sum, all-reduced and divided by the global count) and the
    parameters after one AdamW step equal the JAX trainer's at the global
    batch.  LoRA's gradients are the adapters' (and, with train_norms,
    the norm scales'): the frozen base has none."""
    r0, r1 = world[0][case], world[1][case]
    want_loss, want_grads, want_step_loss, want_params = jax_refs[case]
    assert r0["losses"][0] == r1["losses"][0]
    np.testing.assert_allclose(r0["losses"][0], want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["losses"][0], want_step_loss,
                               rtol=LOSS_RTOL)
    got = r0["grads"]
    if CASES[case][0] == "lora":
        assert all(n.startswith(("lora/", "base/layers/ln", "base/ln_f"))
                   for n in got)
        assert any(n.startswith("base/") for n in got) == (
            case == "lora_norms")
    else:
        assert set(got) == set(want_grads)
    for name, g in got.items():
        np.testing.assert_allclose(g, want_grads[name], err_msg=name,
                                   **GRAD_TOL)
    params = r0["step1_params"]
    assert set(params) == set(want_params)
    for name in want_params:
        np.testing.assert_allclose(params[name], want_params[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one_process(world, single, case):
    """The world at 2 x 4 against the port alone at 8: the same loss and
    gradients at 1e-6, the parameters after the step at PARAM_ATOL (the
    first AdamW step moves each entry by lr x g / (|g| + eps), so an
    entry whose gradient is near eps turns a last-bit difference into a
    share of lr); the two replicas end the step equal bit for bit."""
    r0, r1 = world[0][case], world[1][case]
    loss, grads, params = single[case]
    np.testing.assert_allclose(r0["losses"][0], loss, rtol=PORT_TOL["rtol"])
    assert set(r0["grads"]) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(r0["grads"][name], g, err_msg=name,
                                   **PORT_TOL)
        np.testing.assert_array_equal(r1["grads"][name], r0["grads"][name])
    for name, p in params.items():
        np.testing.assert_allclose(r0["step1_params"][name], p, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert same(r0["step1_params"], r1["step1_params"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank1_adopts_rank0_parameters(world, case):
    """Rank 1 starts from other weights (seed 1) and adopts rank 0's bit
    for bit when the world forms, the frozen LoRA base included."""
    r0, r1 = world[0][case], world[1][case]
    assert not same(r1["own_init"], r0["own_init"])
    if CASES[case][0] == "lora":
        # The base's random matrices differ (its norm scales start at 1).
        assert all(not np.array_equal(r1["own_init"][n], r0["own_init"][n])
                   for n in ("base/embed", "base/layers/wq",
                             "base/layers/w_down"))
    assert same(r1["adopted"], r0["own_init"])
    assert same(r0["adopted"], r0["own_init"])


# -- ZeRO-1 --------------------------------------------------------------------


@pytest.mark.parametrize("case", ZERO_CASES)
def test_zero1_on_equals_off_bitwise(world, case):
    """Three steps with zero1=True equal zero1=False bit for bit: losses,
    parameters and the whole AdamW state (the shards gathered, both
    counts of LoRA's two groups).  The shard optimizer has the spec's
    groups, prefixes and hyper-parameters (LoRA's norm group with weight
    decay 0, empty without train_norms), and the whole optimizer holds
    no state."""
    for r in world:
        c = r[case]
        assert c["z1_losses"] == c["losses"]
        assert same(c["z1_params"], c["params"])
        assert same(c["z1_state"], c["state"])
        whole_groups, shard_groups = c["z1_groups"]
        assert [g[:5] for g in shard_groups] == [g[:5] for g in whole_groups]
        assert c["z1_shard_entries"] == 0
    counts = sorted(k for k in world[0][case]["state"]
                    if k.endswith("/count"))
    if CASES[case][0] == "lora":
        assert counts == ["inner_states/train/inner_state/0/count",
                          "inner_states/train_norm/inner_state/0/count"]
        groups = world[0][case]["z1_groups"][1]
        assert [g[2] for g in groups] == [0.01, 0.0]
        assert (groups[1][5] > 0) == (case == "lora_norms")
    else:
        assert counts == ["0/count"]
    assert all(int(world[0][case]["state"][k]) == STEPS for k in counts)


@pytest.mark.parametrize("case", ZERO_CASES)
def test_zero1_report_matches_jax(world, case):
    """``zero1_report`` at a world of 2, ZeRO-1 on and off, gives the JAX
    report's numbers for the same model, optimizer and N (optax's counts
    and LoRA's masked groups, not torch's per-parameter steps)."""
    for zero1, key in ((True, "z1_report"), (False, "off_report")):
        want = jax_trainer(case, None, zero1=zero1).zero1_report()
        for r in world:
            assert r[case][key] == want, (zero1, r[case][key], want)
    report = world[0][case]["z1_report"]
    assert 2 * report["per_device_bytes"] <= 1.01 * report[
        "replicated_equiv_bytes"]


@pytest.mark.parametrize("case", ZERO_CASES)
def test_reform_2_1_2_keeps_adamw_moments(world, case):
    """2 -> 1: rank 0 keeps its parameters and AdamW moments bit for bit
    and steps alone; 1 -> 2: rank 1 adopts rank 0's parameters, moments,
    counts and version bit for bit."""
    r0, r1 = world[0][case], world[1][case]
    assert r0["alone_kept"] and np.isfinite(r0["alone_loss"])
    assert not same(r0["alone_state"], r0["state"])
    for r in (r0, r1):
        assert same(r["regrown_state"], r0["alone_state"])
        assert r["regrown_version"] == STEPS + 1
    assert same(r1["regrown_params"], r0["regrown_params"])


def test_zero1_lora_checkpoint_restores_in_jax(world, ckpt_dir, data):
    """A checkpoint written at version 2 by a two-rank ZeRO-1 LoRA world
    (both groups, the shards gathered) restores into the JAX LoRA trainer:
    its optimizer state, leaf by leaf, is the port world's gathered state
    at version 2 (the moments and counts of both groups, bit for bit);
    its loss on the third batch is the port world's at that version, and
    its parameters after that step, which read the restored moments, are
    the port world's after its third step within PARAM_ATOL."""
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
    from elasticdl_tpu.utils.pytree import flatten_with_names

    r0, r1 = world
    assert r0["ckpt_losses"] == r1["ckpt_losses"]
    trainer = jax_trainer("lora_norms", None, rng_seed=9,
                          checkpoint_saver=JSaver(ckpt_dir))
    assert trainer.init_from_checkpoint() and trainer.version == 2
    restored, _ = flatten_with_names(trainer._opt_state_on_host())
    want = r0["ckpt_state"]
    assert set(restored) == set(want)
    assert {k for k in want if k.endswith("/count")} == {
        "inner_states/train/inner_state/0/count",
        "inner_states/train_norm/inner_state/0/count"}
    for k, v in restored.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    loss = float(trainer.train_minibatch(data[2], data[2])[0])
    np.testing.assert_allclose(loss, r0["ckpt_losses"][2], rtol=LOSS_RTOL)
    params = trainer.export_parameters()
    assert set(params) == set(r0["ckpt_params"])
    for name, p in params.items():
        np.testing.assert_allclose(r0["ckpt_params"][name], p, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
