"""ZeRO-1 weight-update sharding in the port (elasticdl_tpu_torch/worker/
zero.py and the ``zero1`` path of worker/collective_trainer.py): the port
of tests/test_zero1.py, each of its 13 tests under its reference name,
on gloo worlds of spawned CPU processes, and the cases the port's own
re-form contract adds.

The contract under test:

 - layout: the port's ``ZeroPartitioner`` has the JAX partitioner's
   per-leaf geometry (element count, padded length) and byte counts for
   the same model, optimizer and shard count;
 - trajectory: ZeRO-1 on equals ZeRO-1 off bit for bit within the port
   (per step, through windows, with accumulation), and follows the JAX
   trainer at ``zero1=True`` on a 2-device CPU mesh within the
   tolerances of tests/test_torch_collective_mesh.py (losses rtol 2e-4
   over 12 steps, parameters after the third step atol 1e-4: past it,
   Adam turns last-bit gradient differences of a near-zero gradient
   into whole steps of the learning rate);
 - re-forms: the whole optimizer state is bit for bit the same after a
   re-form whose world holds every shard of rank 0's layout (2 -> 3,
   2 -> 2, 1 -> 2), and restarts from the parameters when one is lost
   (3 -> 2, 2 -> 1, a step that failed between its shard update and its
   parameter all-gather);
 - checkpoints: the file holds the whole state in original shapes and
   moves between ZeRO-1 on, off and the JAX trainer, with equal
   parameters and moments.

Two of the reference tests fail on this tree for the JAX package
(``test_zero1_per_step_bitwise_equivalence`` and
``test_zero1_fused_window_bitwise_equivalence[4]``: its sharded update
drifts by an ulp from the replicated one on 8 virtual devices); the port
holds its own invariant there, bit-equality of ZeRO-1 on and off, which
it meets by construction (the same all-reduced gradients and the same
per-element update).

Models: ``mnist`` (Adam) and ``resnet_small_cifar10`` (SGD momentum;
GroupNorm on the plain versions, the CPU's).  The checks are grouped by
spawned world: one of two ranks and one of three, each computed once for
the module; the JAX side runs in the test process only.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.parallel import launch
from elasticdl_tpu_torch.worker.zero import ZeroPartitioner

RTOL = 2e-4
PARAM_ATOL = 1e-4
LR = {"mnist": 1e-3, "resnet_small_cifar10": 0.01}
BATCH = {"mnist": 8, "resnet_small_cifar10": 2}
STEPS = 12
RANKS_TIMEOUT_S = 300


def port_spec(model):
    if model == "mnist":
        from elasticdl_tpu_torch.models import mnist
        return mnist.model_spec(learning_rate=LR[model])
    from elasticdl_tpu_torch.models import resnet
    return resnet.model_spec(model, learning_rate=LR[model])


def jax_spec(model):
    if model == "mnist":
        from elasticdl_tpu.models import mnist
        return mnist.model_spec(learning_rate=LR[model])
    from elasticdl_tpu.models import resnet
    return resnet.model_spec(model, learning_rate=LR[model])


def global_batches(model, steps, seed, ranks=2, accum=1):
    """``steps`` global batches of ``ranks`` x B x ``accum`` rows."""
    n = ranks * BATCH[model] * accum
    rng = np.random.RandomState(seed)
    shape = (28, 28) if model == "mnist" else (32, 32, 3)
    return [(rng.rand(n, *shape).astype(np.float32),
             rng.randint(0, 10, size=n).astype(np.int32))
            for _ in range(steps)]


def local(batch, rank, b, ranks=2, accum=1):
    """Rank ``rank``'s rows of a global batch, microbatch by microbatch
    (the JAX ``_globalize`` order, tests/test_torch_collective_mesh.py)."""
    xs, ys = batch
    rows = np.concatenate([np.arange((ranks * i + rank) * b,
                                     (ranks * i + rank + 1) * b)
                           for i in range(accum)])
    return xs[rows], ys[rows]


def port_trainer(model, **kwargs):
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    return CollectiveTrainer(port_spec(model), batch_size=BATCH[model],
                             device="cpu", **kwargs)


def whole(trainer):
    """Host copies of the whole optimizer state (``{optax name:
    ndarray}``, the parameters' torch layouts); a collective under ZeRO-1
    in a world, so every member calls it together."""
    return {k: (v.detach().cpu().numpy().copy()
                if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in trainer._whole_state().items()}


def same(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def fresh(state):
    """Whether ``state`` is the optimizer's initial state (zeros)."""
    return all(not np.any(v) for v in state.values())


def zero1_counters(trainer):
    return {k: v for k, v in trainer.timing.counters().items()
            if k.startswith("zero1_")}


# -- the world of two ranks ----------------------------------------------------


def world_of_two(batches, accum_batches, res_batches, dirs):
    """Everything the module checks on a fixed world of two ranks, in one
    spawn: each trainer is built over its own data mesh of the world."""
    from elasticdl_tpu_torch.parallel.mesh import data_mesh
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    rank, b = dist.get_rank(), BATCH["mnist"]

    def mesh():
        return data_mesh(backend="gloo", device="cpu")

    def trainer(zero1, model="mnist", **kwargs):
        return port_trainer(model, mesh=mesh(), zero1=zero1, **kwargs)

    def mine(i, model="mnist", data=batches):
        return local(data[i], rank, BATCH[model])

    def run(t, steps, start=0):
        return [float(t.train_minibatch(*mine(start + i))[0])
                for i in range(steps)]

    out = {}
    # Per step, ZeRO-1 off and on.
    base, z1 = trainer(False), trainer(True)
    out["per_step"] = (run(base, STEPS), run(z1, 3))
    out["step3_params"] = z1.export_parameters()
    out["per_step"][1].extend(run(z1, STEPS - 3, start=3))
    out["per_step_params"] = (base.export_parameters(),
                              z1.export_parameters())
    out["per_step_state"] = (whole(base), whole(z1))
    zero = z1._zero
    out["coverage"] = {
        "shard_lens": {name: s.numel() for name, s in
                       z1._shard_state().items()
                       if isinstance(s, torch.Tensor)},
        "want_lens": {name: zero.shard_len(spec) for name, spec in
                      zip(zero.state_names, zero.state_specs)
                      if spec.padded},
        "whole_state_entries": len(z1._optimizer.state),
        "report": z1.zero1_report()}
    out["off"] = {
        "no_partitioner": base._zero is None and base._shard_opt is None,
        "counters": zero1_counters(base),
        "summary_has_zero1": "zero1" in base.timing.summary(),
        "report": base.zero1_report(),
        "slot_shapes_are_params": all(
            tuple(base._optimizer.state[p]["exp_avg"].shape)
            == tuple(p.shape) for p in base.module.parameters())}
    # Windows of 1 and 4, two each.
    for k in (1, 4):
        losses = []
        for zero1 in (False, True):
            t = trainer(zero1)
            got = []
            for w in range(2):
                prepared = [t.prepare_batch(*mine(w * k + i))
                            for i in range(k)]
                lw, _ = t.train_window(t.stage_window(prepared))
                got += np.atleast_1d(lw.detach().numpy()).tolist()
            losses.append(got)
        out["window%d" % k] = losses
    # Two microbatches a step.
    out["accum"] = [
        [float(t.train_minibatch(*local(accum_batches[i], rank, b,
                                        accum=2))[0])
         for i in range(6)]
        for t in (trainer(False, accum_steps=2),
                  trainer(True, accum_steps=2))]
    # The timing section: one step and a window of three.
    t = trainer(True)
    t.train_minibatch(*mine(0))
    t.train_window(t.stage_window([t.prepare_batch(*mine(i))
                                   for i in range(1, 4)]))
    t.timing.report()
    out["timing"] = (t.timing.summary().get("zero1"),
                     t._zero.flat_param_bytes(), t.zero1_report())
    # A same-size re-form: the world of the same two ranks on new groups,
    # after snapshot_to_host, against the no-churn trajectory.
    ref = trainer(True)
    ref_losses = run(ref, 6)
    churn = trainer(True)
    churn_losses = run(churn, 3)
    churn.snapshot_to_host()
    out["snapshot"] = {
        "alone": churn.process_count == 1 and churn._mesh is None,
        "shards_kept": churn._zero is not None and churn._zero.num_shards == 2,
        "counters": zero1_counters(churn)}
    churn.rebuild(mesh())
    churn_losses += run(churn, 3, start=3)
    out["reform"] = (ref_losses, churn_losses, zero1_counters(churn))
    # Checkpoints: ZeRO-1 -> ZeRO-1, ZeRO-1 -> off, off -> ZeRO-1, and a
    # JAX checkpoint (written at version 2 by the test process) -> ZeRO-1.
    # Worker 0 (rank 0) writes; both ranks join the cadence's gather.
    for src, zero1 in (("z1", True), ("off", False)):
        t = trainer(zero1, checkpoint_saver=CheckpointSaver(dirs[src]),
                    checkpoint_steps=2, checkpoint_writer=rank == 0)
        run(t, 2)
        t.flush_checkpoints()
        out["ckpt_state_" + src] = whole(t)
        dist.barrier()
    for src, zero1 in (("z1", True), ("z1", False), ("off", True),
                       ("jax", True)):
        t = trainer(zero1, checkpoint_saver=CheckpointSaver(dirs[src]),
                    rng_seed=99)
        restored = t.init_from_checkpoint()
        state, params = whole(t), t.export_parameters()
        key = "ckpt_%s_to_%s" % (src, "z1" if zero1 else "off")
        out[key] = (restored, t.version, state, run(t, 2, start=2), params)
    # ResNet (SGD momentum): per step, off and on.
    res = [trainer(zero1, "resnet_small_cifar10") for zero1 in (False, True)]
    out["resnet"] = [[float(t.train_minibatch(*mine(
        i, "resnet_small_cifar10", res_batches))[0]) for i in range(3)]
        for t in res]
    out["resnet_state"] = [whole(t) for t in res]
    out["resnet_report"] = res[1].zero1_report()
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {k: str(tmp_path_factory.mktemp(k)) for k in ("z1", "off", "jax")}


@pytest.fixture(scope="module")
def data():
    return {"batches": global_batches("mnist", STEPS, seed=21),
            "accum": global_batches("mnist", 6, seed=25, accum=2),
            "resnet": global_batches("resnet_small_cifar10", 3, seed=27)}


@pytest.fixture(scope="module")
def named_init():
    """The port's seeded init (seed 0) in JAX names, for the JAX side."""
    return port_trainer("mnist").export_parameters()


def jax_mesh_trainer(named, **kwargs):
    """The JAX trainer on a 2-device CPU mesh at ZeRO-1, from ``named``."""
    import jax
    from jax.sharding import Mesh

    from elasticdl_tpu.utils.pytree import to_numpy, unflatten_from_names
    from elasticdl_tpu.worker.collective_trainer import CollectiveTrainer

    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    trainer = CollectiveTrainer(jax_spec("mnist"), batch_size=BATCH["mnist"],
                                mesh=mesh, zero1=True, **kwargs)
    if named is not None:
        trainer.set_params(unflatten_from_names(to_numpy(trainer.params),
                                                named))
    return trainer


@pytest.fixture(scope="module")
def jax_run(data, dirs, named_init):
    """The JAX trainer's ZeRO-1 trajectory over the same global batches,
    and its checkpoint at version 2 (for the ranks to restore)."""
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver

    batches = data["batches"]
    trainer = jax_mesh_trainer(named_init)
    losses = [float(trainer.train_minibatch(*batch)[0])
              for batch in batches[:3]]
    step3 = trainer.export_parameters()
    losses += [float(trainer.train_minibatch(*batch)[0])
               for batch in batches[3:]]
    writer = jax_mesh_trainer(named_init,
                              checkpoint_saver=JSaver(dirs["jax"]),
                              checkpoint_steps=2)
    for batch in batches[:2]:
        writer.train_minibatch(*batch)
    writer.flush_checkpoints()
    return {"losses": losses, "step3_params": step3}


@pytest.fixture(scope="module")
def two(data, dirs, jax_run):
    results = launch.spawn(world_of_two, 2, (
        data["batches"], data["accum"], data["resnet"], dirs), threads=1,
        timeout=RANKS_TIMEOUT_S)
    return results


# -- trajectory equivalence ----------------------------------------------------


def test_zero1_per_step_bitwise_equivalence(two, jax_run):
    """Same seed, same batches: ZeRO-1 losses, parameters and optimizer
    state equal the replicated path's bit for bit on both ranks, over
    enough steps for a 1-ulp drift to show; and the trajectory follows
    the JAX trainer's at zero1=True (the reference test fails on this
    tree for the JAX package; this is the port's own invariant)."""
    for r in two:
        base, z1 = r["per_step"]
        assert base == z1
        assert same(*r["per_step_params"])
        assert same(*r["per_step_state"])
    assert two[0]["per_step"][1] == two[1]["per_step"][1]
    np.testing.assert_allclose(two[0]["per_step"][1], jax_run["losses"],
                               rtol=RTOL)
    got, want = two[0]["step3_params"], jax_run["step3_params"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("window", [1, 4])
def test_zero1_fused_window_bitwise_equivalence(two, window):
    """K steps a dispatch: the ZeRO-1 window reproduces the replicated
    window bit for bit (for K=4 the reference fails on this tree; the
    port's window is K single steps, so it holds by construction)."""
    for r in two:
        base, z1 = r["window%d" % window]
        assert len(base) == 2 * window
        assert base == z1


def test_zero1_accum_bitwise_equivalence(two):
    """Gradient accumulation composes with the sharded update exactly."""
    for r in two:
        base, z1 = r["accum"]
        assert base == z1


# -- full coverage + unpad fidelity ------------------------------------------


def test_zero1_full_coverage_every_nonscalar_leaf_sharded(two):
    """Every non-scalar slot lives as a flat padded 1/N shard in the shard
    optimizer (the whole optimizer keeps no state); only the step count
    stays whole.  Per-rank bytes sit within 1 % of replicated/N."""
    for r in two:
        cov = r["coverage"]
        assert cov["shard_lens"] == cov["want_lens"]
        assert cov["whole_state_entries"] == 0
        report = cov["report"]
        assert report["mode"] == "zero1" and report["num_shards"] == 2
        assert report["scalar_leaves_replicated"] == 1   # Adam's count
        assert report["per_device_bytes"] <= (
            report["replicated_equiv_bytes"] / report["num_shards"] * 1.01)
        res = r["resnet_report"]
        assert res["mode"] == "zero1" and res["scalar_leaves_replicated"] == 0


def test_unpad_fidelity_odd_shapes():
    """Flat-pad then unpad is the identity for shapes that do not divide
    the shard count ([10] pads to [16] over 8), bit for bit, with zero
    padding; cutting every rank's shard and assembling them gives the
    state back; channels-last tensors flatten in their logical order."""
    rng = np.random.RandomState(0)
    params = {"odd_bias": torch.tensor(rng.randn(10), dtype=torch.float32),
              "odd_mat": torch.tensor(rng.randn(7, 3), dtype=torch.float32),
              "even": torch.tensor(rng.randn(16), dtype=torch.float32),
              "conv": torch.tensor(rng.randn(4, 3, 3, 3),
                                   dtype=torch.float32).to(
                  memory_format=torch.channels_last)}
    geometry = [(k, tuple(v.shape), v.dtype) for k, v in params.items()]
    state = dict(params, count=np.asarray(3, np.int32))
    part = ZeroPartitioner(geometry, geometry + [("count", (), np.int32)],
                           8, rank=5)
    flat = part.flatten_params(list(params.values()))
    assert [tuple(f.shape) for f in flat] == [(16,), (24,), (16,), (112,)]
    assert flat[0][10:].tolist() == [0.0] * 6
    for got, want in zip(part.unflatten_params(flat), params.values()):
        assert torch.equal(got, want)
    back = part.unflatten_state(part.flatten_state(state))
    assert all(torch.equal(back[k], v) for k, v in params.items())
    shards = [part.cut_state(state, rank=r) for r in range(8)]
    assert tuple(shards[5]["odd_mat"].shape) == (3,)
    assert torch.equal(shards[5]["odd_mat"],
                       params["odd_mat"].reshape(-1)[15:18])
    assert shards[7]["odd_bias"].tolist() == [0.0, 0.0]
    assembled = part.assemble_state(shards)
    assert all(torch.equal(assembled[k], v) for k, v in params.items())
    assert int(assembled["count"]) == 3


@pytest.mark.parametrize("model", ["mnist", "resnet_small_cifar10"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_zero1_layout_matches_jax(model, n):
    """For the same model, optimizer and N, every parameter and state leaf
    has the JAX partitioner's element count and padded length (matched
    by name), and ``state_bytes`` and ``flat_param_bytes`` read the same
    numbers (optax's one count, not torch's per-parameter steps)."""
    import jax
    from jax.sharding import Mesh

    from elasticdl_tpu.utils.pytree import flatten_with_names
    from elasticdl_tpu.worker.zero import ZeroPartitioner as JaxPartitioner

    trainer = port_trainer(model)
    port = trainer._partitioner(n)
    params = {}
    for name, value in trainer.export_parameters().items():
        *path, leaf = name.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    tx = jax_spec(model).optimizer
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("data",))
    jpart = JaxPartitioner(tx, params, mesh)
    state_shapes = jax.eval_shape(tx.init, params)
    jstate = dict(zip(flatten_with_names(state_shapes)[0],
                      jpart.state_specs))
    assert set(jstate) == set(port.state_names)
    for name, spec in zip(port.state_names, port.state_specs):
        assert (spec.size, spec.padded) == (jstate[name].size,
                                            jstate[name].padded), name
    jparams = dict(zip(flatten_with_names(params)[0], jpart.param_specs))
    for name, spec in zip(port.param_names, port.param_specs):
        assert (spec.size, spec.padded) == (jparams[name].size,
                                            jparams[name].padded), name
    flat_state = jax.eval_shape(jpart.flatten_state, state_shapes)
    assert port.state_bytes() == jpart.state_bytes(flat_state)
    assert port.flat_param_bytes() == jpart.flat_param_bytes()


# -- elastic re-partition ----------------------------------------------------


def _mesh(group):
    from elasticdl_tpu_torch.parallel.mesh import Mesh

    n = dist.get_world_size(group)
    shape = dict(dp=n, pp=1, ep=1, tp=1, sp=1)
    coords = dict(dp=dist.get_rank(group), pp=0, ep=0, tp=0, sp=0)
    return Mesh(shape, coords, {"dp": group}, group, torch.device("cpu"))


def world_of_three():
    """Ranks a (0), b (1) and c (2, its own init) re-form through the
    worlds {a, b} -> {a, b, c} -> {a, c} (b leaves) -> {a, c} again ->
    a step that fails after its shard update on both -> {a, c} -> a
    alone -> {a, c}: each world a group of the spawned world's ranks (a
    trainer sees only its mesh), the members' states read after each."""
    from elasticdl_tpu_torch.parallel import transport

    rank, b = dist.get_rank(), BATCH["mnist"]
    groups = {key: dist.new_group(ranks, backend="gloo") for key, ranks in (
        ("ab", [0, 1]), ("abc", [0, 1, 2]), ("ac", [0, 2]),
        ("ac_again", [0, 2]), ("ac_failed", [0, 2]), ("ac_regrown", [0, 2]))}
    t = port_trainer("mnist", zero1=True, rng_seed=7 if rank == 2 else 0)
    rng = np.random.RandomState(rank)

    def step():
        xs = rng.rand(b, 28, 28).astype(np.float32)
        ys = rng.randint(0, 10, size=b).astype(np.int32)
        return float(t.train_minibatch(xs, ys)[0])

    def reform(key):
        t.snapshot_to_host()
        t.rebuild(_mesh(groups[key]) if key else None)
        return whole(t), zero1_counters(t)

    out = {}
    if rank < 2:
        t.rebuild(_mesh(groups["ab"]))
        [step() for _ in range(2)]
        out["ab"] = whole(t)
    out["abc"] = reform("abc")
    out["abc_params"] = t.export_parameters()
    [step() for _ in range(2)]
    out["abc_stepped"] = whole(t)
    zero = t._zero
    # The padded tails of this rank's shards stay zero (rank 2 holds
    # every tail of a leaf that does not divide by 3).
    out["tails"] = [
        float(s[zero.shard_len(spec) - (spec.padded - spec.size):]
              .abs().sum()) if rank == 2 else 0.0
        for s, spec in zip(t._shards, zero.param_specs)
        if spec.padded != spec.size] + [
        float(v[-(spec.padded - spec.size):].abs().sum()) if rank == 2
        else 0.0
        for (name, v), spec in zip(t._shard_state().items(),
                                   zero.state_specs)
        if spec.padded and spec.padded != spec.size]
    out["abc_stepped_params"] = t.export_parameters()
    if rank == 1:
        t.snapshot_to_host()
        return out
    out["ac"] = reform("ac")
    out["ac_params"] = t.export_parameters()
    step()
    out["ac_stepped"] = whole(t)
    out["ac_again"] = reform("ac_again")
    params = t.export_parameters()
    real = transport.all_gather_flat_

    def fail(*args):
        raise RuntimeError("injected failure before the parameter gather")

    transport.all_gather_flat_ = fail
    try:
        step()
        out["failed"] = False
    except RuntimeError:
        out["failed"] = True
    finally:
        transport.all_gather_flat_ = real
    out["after_failure"] = (t.version, t._shard_finished)
    out["ac_failed"] = reform("ac_failed")
    out["params_kept"] = same(params, t.export_parameters())
    t.snapshot_to_host()
    if rank == 0:
        out["alone"] = reform(None)
        step()
        out["alone_stepped"] = whole(t)
    out["ac_regrown"] = reform("ac_regrown")
    step()
    out["final_params"] = t.export_parameters()
    return out


@pytest.fixture(scope="module")
def three():
    return launch.spawn(world_of_three, 3, (), threads=1,
                        timeout=RANKS_TIMEOUT_S)


def test_repartition_preserves_moments_bitwise(three):
    """2 -> 3 with a joiner and 1 -> 2: the whole state (moments, count)
    after the re-form is the one before it, bit for bit, on every member
    (the joiner included); the re-partition is counted, no reset; the
    padded tails stay zero through steps at 3 shards."""
    a, b, c = three
    for r in (a, b, c):
        state, counters = r["abc"]
        assert same(state, a["ab"])
        assert counters.get("zero1_moment_resets", 0) == 0
        assert counters["zero1_repartitions"] >= 1
        assert counters["zero1_reshard_bytes"] > 0
        assert same(r["abc_stepped"], a["abc_stepped"])
        assert not fresh(r["abc_stepped"])
    assert not any(c["tails"]) and len(c["tails"]) > 0
    for r in (a, c):
        state, counters = r["ac_regrown"]
        assert same(state, a["alone_stepped"])
    assert same(a["final_params"], c["final_params"])


def test_same_size_reform_trajectory_bitwise(two, three):
    """A re-form of the same two ranks continues the no-churn trajectory
    bit for bit, and keeps the whole state bit for bit."""
    for r in two:
        ref, churn, counters = r["reform"]
        assert churn == ref
        assert counters.get("zero1_moment_resets", 0) == 0
    a, _, c = three
    for r in (a, c):
        assert same(r["ac_again"][0], a["ac_stepped"])


def test_snapshot_to_host_gathers_sharded_state(two):
    """The port's form: ``snapshot_to_host`` enters no collective (the
    members of a world leave it at different moments) and drops the mesh
    but keeps the shards; the next ``rebuild`` puts them back together
    over the new world, and the trajectory resumes exactly."""
    for r in two:
        snap = r["snapshot"]
        assert snap["alone"] and snap["shards_kept"]
        assert "zero1_reshard_bytes" not in snap["counters"]
        ref, churn, _ = r["reform"]
        assert churn[3:] == ref[3:]


def test_zero1_leaver_restarts_moments(three):
    """3 -> 2 (a member leaves with its shard) and 2 -> 1 (a planned
    shrink): the moments restart from the parameters, the parameters and
    version are kept, and ``zero1_moment_resets`` counts each."""
    a, _, c = three
    for r in (a, c):
        state, counters = r["ac"]
        assert fresh(state)
        assert counters["zero1_moment_resets"] == 1
        assert same(r["ac_params"], a["abc_stepped_params"])
    state, counters = a["alone"]
    assert fresh(state) and counters["zero1_moment_resets"] == 3


def test_zero1_failed_gather_restarts_moments(three):
    """A step that fails between its shard update and its parameter
    all-gather (on both members) leaves each shard a step ahead of the
    parameters: the version does not move, the shard is marked
    unfinished, and the re-form restarts the moments while keeping the
    parameters of before the step."""
    a, _, c = three
    for r in (a, c):
        assert r["failed"]
        version, finished = r["after_failure"]
        assert not finished
        state, counters = r["ac_failed"]
        assert fresh(state)
        assert counters["zero1_moment_resets"] == 2
        assert r["params_kept"]
    assert a["after_failure"][0] == c["after_failure"][0] == 5


def test_zero1_holders():
    """Which member holds each shard of rank 0's layout (descriptors:
    layout world, layout rank, layout id, version, finished, nonce)."""
    from elasticdl_tpu_torch.worker.collective_trainer import _holders

    # 2 -> 3: the old members hold both shards, the joiner none.
    assert _holders([[2, 0, 9, 4, 1, 0], [2, 1, 9, 4, 1, 0],
                     [1, 0, 5, 0, 1, 0]]) == [0, 1]
    # Rank 0 whole (a world of 1 before).
    assert _holders([[1, 0, 5, 4, 1, 0], [2, 1, 9, 3, 1, 0]]) == [0]
    # 3 -> 2: shard 1 left.
    assert _holders([[3, 0, 9, 4, 1, 0], [3, 2, 9, 4, 1, 0]]) is None
    # A stale shard (another version) or an unfinished one does not count.
    assert _holders([[2, 0, 9, 4, 1, 0], [2, 1, 9, 3, 1, 0]]) is None
    assert _holders([[2, 0, 9, 4, 1, 0], [2, 1, 9, 4, 0, 0]]) is None
    assert _holders([[2, 0, 9, 4, 0, 0], [2, 1, 9, 4, 1, 0]]) is None
    # Another layout's shard of the same size does not count.
    assert _holders([[2, 0, 9, 4, 1, 0], [2, 1, 8, 4, 1, 0]]) is None
    # Shards in another order of the new ranks.
    assert _holders([[2, 1, 9, 4, 1, 0], [1, 0, 5, 0, 1, 0],
                     [2, 0, 9, 4, 1, 0]]) == [2, 0]


# -- persistence ---------------------------------------------------------------


def _file_state(directory):
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    dense, version = CheckpointSaver(directory).load()
    return dense, version


def _as_port(dense):
    """A checkpoint's ``opt/`` entries in the port's torch layouts."""
    from elasticdl_tpu_torch.models.spec import from_jax_layout

    return {k[len("opt/"):]: (from_jax_layout(v).numpy()
                              if np.ndim(v) else np.asarray(v))
            for k, v in dense.items() if k.startswith("opt/")}


def test_zero1_checkpoint_roundtrip_sharded(two, dirs):
    """ZeRO-1 -> checkpoint -> ZeRO-1 (another init seed): the file holds
    the original unpadded shapes, the restore cuts shards equal to the
    writer's state, and the trajectory resumes exactly."""
    dense, version = _file_state(dirs["z1"])
    assert version == 2
    assert dense["opt/0/mu/Dense_0/kernel"].shape == (3136, 128)
    assert dense["opt/0/mu/Dense_1/bias"].shape == (10,)
    assert same(_as_port(dense), two[0]["ckpt_state_z1"])
    ref = two[0]["reform"][0]
    for r in two:
        restored, v, state, losses, _ = r["ckpt_z1_to_z1"]
        assert restored and v == 2
        assert same(state, r["ckpt_state_z1"])
        assert losses == ref[2:4]


def test_zero1_checkpoint_portable_to_replicated(two, dirs, data):
    """The file is mode-independent: a ZeRO-1 checkpoint restores into the
    port at ZeRO-1 off and into the JAX trainer (ZeRO-1 on its mesh), a
    ZeRO-1-off checkpoint into ZeRO-1, and a JAX ZeRO-1 checkpoint into
    the port's ZeRO-1: equal parameters and moments after each restore,
    the port's trajectories bit for bit, the JAX one within RTOL."""
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
    from elasticdl_tpu.utils.pytree import flatten_with_names

    ref = two[0]["reform"][0]
    for key, src in (("ckpt_z1_to_off", "z1"), ("ckpt_off_to_z1", "off")):
        for r in two:
            restored, v, state, losses, _ = r[key]
            assert restored and v == 2
            assert same(state, r["ckpt_state_" + src])
            assert losses == ref[2:4]
    batches = data["batches"]
    jtrainer = jax_mesh_trainer(None, rng_seed=99,
                                checkpoint_saver=JSaver(dirs["z1"]))
    assert jtrainer.init_from_checkpoint()
    dense, _ = _file_state(dirs["z1"])
    opt, _ = flatten_with_names(jtrainer._opt_state_on_host())
    assert set(opt) == {k[len("opt/"):] for k in dense if
                        k.startswith("opt/")}
    for k, v in opt.items():
        np.testing.assert_array_equal(v, dense["opt/" + k], err_msg=k)
    want = [float(jtrainer.train_minibatch(*batch)[0])
            for batch in batches[2:4]]
    np.testing.assert_allclose(ref[2:4], want, rtol=RTOL)
    # JAX -> port.
    jdense, _ = _file_state(dirs["jax"])
    for r in two:
        restored, v, state, losses, params = r["ckpt_jax_to_z1"]
        assert restored and v == 2
        assert same(state, _as_port(jdense))
        assert same(params, {k: v for k, v in jdense.items()
                             if not k.startswith("opt/")})
    jax_after = jax_mesh_trainer(None, rng_seed=99,
                                 checkpoint_saver=JSaver(dirs["jax"]))
    assert jax_after.init_from_checkpoint()
    jlosses = [float(jax_after.train_minibatch(*batch)[0])
               for batch in batches[2:4]]
    np.testing.assert_allclose(two[0]["ckpt_jax_to_z1"][3], jlosses,
                               rtol=RTOL)


# -- off switch + observability ------------------------------------------------


def test_zero1_off_is_exact_old_layout(two):
    """zero1=False keeps the replicated layout: no partitioner, slots in
    the parameters' shapes, no zero1 counters or timing section, and the
    report's mode is "replicated" with the JAX report's numbers."""
    for r in two:
        off = r["off"]
        assert off["no_partitioner"] and off["slot_shapes_are_params"]
        assert off["counters"] == {} and not off["summary_has_zero1"]
        report = off["report"]
        assert report["mode"] == "replicated"
        assert report["per_device_bytes"] == report["replicated_equiv_bytes"]
        z1 = r["coverage"]["report"]
        assert report["replicated_equiv_bytes"] == z1[
            "replicated_equiv_bytes"]


def test_zero1_timing_section_and_report(two):
    """Each step books one flat parameter list of reduction and one of
    all-gather payload; the counters make the ``zero1`` section of
    ``Timing.summary()`` and ``report()`` takes it."""
    for r in two:
        section, flat_bytes, report = r["timing"]
        assert section["zero1_reduce_scatter_bytes"] == flat_bytes * 4
        assert section["zero1_all_gather_bytes"] == flat_bytes * 4
        assert section["zero1_repartitions"] == 1
        assert report["mode"] == "zero1"


def test_zero1_single_device_mesh():
    """Alone (no world, or a world of one), ZeRO-1 runs the whole
    optimizer: steps run, equal to zero1=False's bit for bit, and there
    is no report (None, as the JAX trainer without a mesh)."""
    from elasticdl_tpu_torch.models import mnist

    xs, ys = mnist.synthetic_data(n=16, seed=43)
    z1 = port_trainer("mnist", zero1=True)
    base = port_trainer("mnist")
    for _ in range(3):
        loss, _ = z1.train_minibatch(xs[:8], ys[:8])
        want, _ = base.train_minibatch(xs[:8], ys[:8])
        assert np.isfinite(float(loss)) and float(loss) == float(want)
    assert z1.zero1_report() is None and z1._zero is None
    assert same(whole(z1), whole(base))


# -- the resnet world (SGD momentum) -----------------------------------------


def test_zero1_sgd_momentum_bitwise(two):
    """resnet_small_cifar10 with SGD momentum: ZeRO-1 on equals off bit
    for bit (losses and momentum), on both ranks."""
    for r in two:
        base, z1 = r["resnet"]
        assert base == z1 and all(np.isfinite(base))
        assert same(*r["resnet_state"])
