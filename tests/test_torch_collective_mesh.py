"""The port's CollectiveTrainer over a data mesh of two gloo ranks on the
CPU (elasticdl_tpu_torch/worker/collective_trainer.py), against the JAX
package's CollectiveTrainer on a 2-device mesh (tests/conftest.py gives
8 virtual CPU devices): the ports of
tests/test_collective_trainer.py::test_mesh_step_matches_single_device,
::test_elastic_mesh_rebuild and ::test_restore_on_mesh_resumes_trajectory.

Both packages start from the port's seeded init (carried into JAX by the
npz names).  The JAX trainer runs at ``batch_size`` B per device, a
global batch of 2B; each port rank trains at B on its half of the same
global batch.  A partial last batch of 2B - 3 rows fills rank 0 and
leaves rank 1 three padded rows (weight 0), as the JAX mesh pads the
global batch's tail.  Models: ``mnist`` (Adam) and
``resnet_small_cifar10`` (SGD momentum; GroupNorm on the plain versions,
the CPU's).

Tolerances: losses at rtol 2e-4, the reference's own; parameters after
the third step at atol 1e-4 (tests/test_torch_trainer.py's: convs and
sums in other orders, amplified by resnet's loss jump at step 2).  The
rebuild 2 -> 1 -> 2 is exact: parameters, optimizer moments, count and
version carried bit for bit, and a joiner with other parameters adopting
rank 0's bit for bit.

Meshes beyond dp (``parallel/distributed.elastic_mesh_builder``): a
(dp=2, tp=2) world of 4 ranks and a (dp=1, sp=2) world of 2 against the
JAX CollectiveTrainer on ``build_mesh`` over as many CPU devices with
``data_axis="dp"``.  The JAX trainer runs at B a device, so its global
batch of B x devices is split over dp and replicated over the other
axes; a port rank trains at B x devices / dp rows, and the ranks of one
dp coordinate (replicas) are fed the same rows.  The port sums over the
whole world, each row once per replica in the sum and the count alike.
Gradients at tests/test_torch_collective_lm.py's 1e-4 relative + 1e-5
absolute.  The re-form 4 -> 2 -> 4 under ``elastic_mesh_builder(tp=2)``
with ZeRO-1 on (its shards over dp only) carries the survivors' state
bit for bit.  Replicas fed rows of their own (the worker's task stream
feeds each rank its own) take one step over all the rows and stay bit
for bit one another.

Ranks are spawned processes (``parallel/launch.py``: ``spawn`` for a
fixed world, ``run`` for the re-formed ones), under a time limit; this
module imports JAX only in the test process, inside the tests.
"""

import concurrent.futures

import numpy as np
import pytest
import torch.distributed as dist

from elasticdl_tpu_torch.parallel import distributed as tdist
from elasticdl_tpu_torch.parallel import launch

RTOL = 2e-4
PARAM_ATOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"mnist": 1e-3, "resnet_small_cifar10": 0.01}
BATCH = {"mnist": 8, "resnet_small_cifar10": 2}
RANKS_TIMEOUT_S = 240


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


def global_batches(model, steps, seed, partial_last=True, accum=1):
    """``steps`` global batches of 2B x ``accum`` rows (3 rows fewer in
    the last when ``partial_last``)."""
    b2 = 2 * BATCH[model] * accum
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        n = b2 - 3 if partial_last and i == steps - 1 else b2
        if model == "mnist":
            xs = rng.rand(n, 28, 28).astype(np.float32)
        else:
            xs = rng.rand(n, 32, 32, 3).astype(np.float32)
        out.append((xs, rng.randint(0, 10, size=n).astype(np.int32)))
    return out


def local(batch, rank, b, accum=1):
    """Rank ``rank``'s rows of a global batch (its task stream's).  The
    global batch lists microbatch by microbatch each rank's b rows, as
    the JAX trainer's global microbatches are the ranks' (``_globalize``
    concatenates [accum, micro] blocks along the micro axis)."""
    xs, ys = batch
    rows = np.concatenate([np.arange((2 * i + rank) * b,
                                     (2 * i + rank + 1) * b)
                           for i in range(accum)])
    rows = rows[rows < len(xs)]
    return xs[rows], ys[rows]


def jax_mesh_trainer(model, named, **kwargs):
    import jax
    from jax.sharding import Mesh

    from elasticdl_tpu.utils.pytree import to_numpy
    from elasticdl_tpu.utils.pytree import unflatten_from_names
    from elasticdl_tpu.worker.collective_trainer import CollectiveTrainer

    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    trainer = CollectiveTrainer(jax_spec(model), batch_size=BATCH[model],
                                mesh=mesh, **kwargs)
    if named is not None:
        trainer.set_params(unflatten_from_names(to_numpy(trainer.params),
                                                named))
    return trainer


def port_single(model, batch_size, **kwargs):
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    return CollectiveTrainer(port_spec(model), batch_size=batch_size,
                             device="cpu", **kwargs)


def assert_params_close(got, want, atol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


def rank_train(model, batches, ckpt_dir=None, rng_seed=0, accum=1):
    """One rank of a 2-rank world made by ``launch.spawn``: a trainer at B
    (``accum`` microbatches a step) over the data mesh (restored from
    ``ckpt_dir`` if given) takes a step on its rows of each global batch.
    Returns the losses, the process and device counts, and rank 0's
    parameters."""
    from elasticdl_tpu_torch.parallel.mesh import data_mesh
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rank, b = dist.get_rank(), BATCH[model]
    trainer = CollectiveTrainer(
        port_spec(model), batch_size=b, device="cpu", rng_seed=rng_seed,
        accum_steps=accum, mesh=data_mesh(backend=tdist.BACKEND, device="cpu"),
        checkpoint_saver=CheckpointSaver(ckpt_dir) if ckpt_dir else None)
    if ckpt_dir:
        assert trainer.init_from_checkpoint()
    losses = [float(trainer.train_minibatch(*local(batch, rank, b, accum))[0])
              for batch in batches]
    return (losses, trainer.process_count, trainer.global_device_count,
            trainer.max_window,
            trainer.export_parameters() if rank == 0 else None)


@pytest.mark.parametrize("model,accum", [
    ("mnist", 1), ("resnet_small_cifar10", 1),
    # Two microbatches a step: each one's mean is over the global
    # microbatch (the ranks' micro i together), as the JAX scan's.
    ("mnist", 2)])
def test_mesh_step_matches_single_device(model, accum):
    """Three steps of the 2-rank world (the last on a partial batch
    padded on rank 1) against the JAX 2-device mesh and against the
    port alone at the global batch."""
    batches = global_batches(model, 3, seed=3, accum=accum)
    single = port_single(model, 2 * BATCH[model], accum_steps=accum)
    named = single.export_parameters()
    jtrainer = jax_mesh_trainer(model, named, accum_steps=accum)
    want = [float(jtrainer.train_minibatch(*batch)[0]) for batch in batches]
    alone = [float(single.train_minibatch(*batch)[0]) for batch in batches]
    results = launch.spawn(rank_train, 2,
                           (model, batches, None, 0, accum), threads=1,
                           timeout=RANKS_TIMEOUT_S)
    for losses, procs, devices, window, _ in results:
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        np.testing.assert_allclose(losses, alone, rtol=RTOL)
        assert (procs, devices, window) == (2, 2, 1)
    assert results[0][0] == results[1][0]   # one global loss
    assert_params_close(results[0][4], jtrainer.export_parameters(),
                        PARAM_ATOL)
    assert_params_close(results[0][4], single.export_parameters(),
                        PARAM_ATOL)


def _state(trainer):
    """Host copies of everything a re-formed world carries: parameters,
    optimizer slots and counts (JAX names), version."""
    from elasticdl_tpu_torch.worker.collective_trainer import (
        _opt_state_to_jax)

    opt = _opt_state_to_jax(trainer._optimizer, trainer._named_params(),
                            lambda t: t.detach().cpu().numpy().copy())
    return (trainer.export_parameters(),
            {k: np.asarray(v) for k, v in opt.items()}, trainer.version)


def _same_state(a, b):
    (pa, oa, va), (pb, ob, vb) = a, b
    return (va == vb and set(pa) == set(pb) and set(oa) == set(ob)
            and all(np.array_equal(pa[k], pb[k]) for k in pa)
            and all(np.array_equal(oa[k], ob[k]) for k in oa))


def rebuild_rank(model, role, epochs, batches):
    """``role`` "survivor" (rank 0 of worlds 2, 1, 2), "leaver" (rank 1 of
    the first) or "joiner" (rank 1 of the last, its own init from another
    seed).  Each world re-forms through ``initialize_from_rendezvous`` on
    the epoch's store."""
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    b = BATCH[model]
    build = tdist.data_mesh_builder("cpu", timeout_secs=60)
    e1, e2, e3 = epochs
    out = {}
    if role == "joiner":
        trainer = CollectiveTrainer(port_spec(model), batch_size=b,
                                    device="cpu", rng_seed=7)
        out["own"] = _state(trainer)
        trainer.rebuild(build(1, 2, e3))
        out["adopted"] = _state(trainer)
        out["loss"] = float(trainer.train_minibatch(
            *local(batches[2], 1, b))[0])
        out["after"] = _state(trainer)
        tdist.reset_single_process()
        return out
    rank = 0 if role == "survivor" else 1
    trainer = CollectiveTrainer(port_spec(model), batch_size=b,
                                device="cpu", mesh=build(rank, 2, e1))
    trainer.train_minibatch(*local(batches[0], rank, b))
    out["world2"] = _state(trainer)
    trainer.snapshot_to_host()
    if role == "leaver":
        tdist.reset_single_process()
        return out
    trainer.rebuild(build(0, 1, e2))           # the world shrinks to 1
    out["world1_kept"] = _same_state(_state(trainer), out["world2"])
    out["alone"] = trainer.process_count, trainer.max_window
    trainer.train_minibatch(*local(batches[1], 0, b))
    out["world1"] = _state(trainer)
    trainer.snapshot_to_host()
    trainer.rebuild(build(0, 2, e3))           # and grows back to 2
    out["world2_kept"] = _same_state(_state(trainer), out["world1"])
    out["loss"] = float(trainer.train_minibatch(*local(batches[2], 0, b))[0])
    out["after"] = _state(trainer)
    tdist.reset_single_process()
    return out


@pytest.mark.parametrize("model", ["mnist", "resnet_small_cifar10"])
def test_elastic_mesh_rebuild(model):
    """World resize 2 -> 1 -> 2 in place: the survivor's parameters,
    moments, count and version carried bit for bit across both re-forms;
    the joiner adopts rank 0's bit for bit and both take the same step."""
    batches = global_batches(model, 3, seed=7, partial_last=False)
    # One service an epoch, so that no store is marked superseded before
    # its world forms (tests/test_torch_distributed.py).
    svcs = [tdist.MasterCoordinationService(reap_secs=120) for _ in range(3)]
    epochs = [svc.start_epoch(n) for svc, n in zip(svcs, (2, 1, 2))]
    survivor, leaver, joiner = launch.run(
        [(rebuild_rank, (model, role, epochs, batches))
         for role in ("survivor", "leaver", "joiner")],
        timeout=RANKS_TIMEOUT_S, threads=1)
    assert _same_state(survivor["world2"], leaver["world2"])
    assert survivor["world1_kept"] and survivor["world2_kept"]
    assert survivor["alone"] == (1, None)
    assert survivor["world1"][2] == 2          # version: one step each
    assert not _same_state(joiner["own"], survivor["world1"])
    assert _same_state(joiner["adopted"], survivor["world1"])
    assert joiner["loss"] == survivor["loss"]
    assert _same_state(joiner["after"], survivor["after"])
    assert survivor["after"][2] == 3


def test_restore_on_mesh_resumes_trajectory(tmp_path):
    """A checkpoint written by the port alone is restored by both ranks
    of a 2-rank world (another init seed), whose next two steps resume
    the trajectory: the port alone and the JAX 2-device mesh restored
    from the same directory take the same losses."""
    from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    model, b2 = "mnist", 2 * BATCH["mnist"]
    batches = global_batches(model, 4, seed=13, partial_last=False)
    ref = port_single(model, b2, rng_seed=6)
    losses_ref = [float(ref.train_minibatch(*batch)[0]) for batch in batches]
    t1 = port_single(model, b2, rng_seed=6,
                     checkpoint_saver=CheckpointSaver(str(tmp_path)),
                     checkpoint_steps=2)
    for batch in batches[:2]:
        t1.train_minibatch(*batch)
    t1.flush_checkpoints()
    results = launch.spawn(rank_train, 2, (model, batches[2:], str(tmp_path),
                                           99),
                           threads=1, timeout=RANKS_TIMEOUT_S)
    jtrainer = jax_mesh_trainer(model, None, rng_seed=99,
                                checkpoint_saver=JSaver(str(tmp_path)))
    assert jtrainer.init_from_checkpoint()
    want = [float(jtrainer.train_minibatch(*batch)[0])
            for batch in batches[2:]]
    for losses, *_ in results:
        np.testing.assert_allclose(losses, losses_ref[2:], rtol=RTOL)
        np.testing.assert_allclose(losses, want, rtol=RTOL)


# -- meshes beyond dp ---------------------------------------------------------

# name: (ranks, the fixed axes of the mesh).
AXES_CASES = {"dp2_tp2": (4, {"tp": 2}), "dp1_sp2": (2, {"sp": 2})}


def dp_rows(batch, dp_rank, dp):
    """The rows of a global batch that the ranks at ``dp_rank`` train on."""
    xs, ys = batch
    n = len(xs) // dp
    return xs[dp_rank * n:(dp_rank + 1) * n], ys[dp_rank * n:(dp_rank + 1) * n]


def axes_rank(model, axes, batch):
    """One rank of a world over ``build_mesh(**axes)``: a trainer from
    its own seed (it adopts rank 0's state), one step on its dp
    coordinate's rows; then the same with ZeRO-1 on."""
    from elasticdl_tpu_torch.models.spec import jax_name
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    mesh = build_mesh(**axes, backend=tdist.BACKEND, device="cpu")
    dp, at = mesh.shape["dp"], mesh.coords["dp"]
    spec = port_spec(model)
    out = {"coords": dict(mesh.coords)}
    for zero1 in (False, True):
        trainer = CollectiveTrainer(
            spec, batch_size=len(batch[0]) // dp, device="cpu",
            rng_seed=dist.get_rank(), mesh=mesh, zero1=zero1)
        loss = float(trainer.train_minibatch(*dp_rows(batch, at, dp))[0])
        out[zero1] = {
            "loss": loss, "params": trainer.export_parameters(),
            "report": trainer.zero1_report(),
            "grads": {jax_name(n): spec.to_jax_layout(p.grad) for n, p in
                      trainer.module.named_parameters()
                      if p.grad is not None},
            "counts": (trainer.process_count, trainer.max_window)}
    return out


def jax_axes_trainer(model, named, ranks, axes):
    """The JAX trainer on ``build_mesh(**axes)`` holding ``named``.  Its
    spec's init returns zeros of the parameters' shapes: ``set_params``
    replaces them (and the optimizer state) before any step, and the
    model's own init runs op by op, seconds for a ResNet."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.utils.pytree import to_numpy
    from elasticdl_tpu.utils.pytree import unflatten_from_names
    from elasticdl_tpu.worker.collective_trainer import CollectiveTrainer

    spec = jax_spec(model)

    def zeros(rng):
        return jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(spec.init_fn, rng))

    mesh = build_mesh(**axes, devices=jax.devices()[:ranks])
    trainer = CollectiveTrainer(dataclasses.replace(spec, init_fn=zeros),
                                batch_size=BATCH[model], mesh=mesh,
                                data_axis="dp")
    trainer.set_params(unflatten_from_names(to_numpy(trainer.params), named))
    return trainer


@pytest.mark.parametrize("model,case", [
    ("mnist", "dp2_tp2"), ("resnet_small_cifar10", "dp2_tp2"),
    ("mnist", "dp1_sp2")])
def test_mesh_axes_match_the_jax_trainer(model, case):
    """One step of a world over a mesh with axes beyond dp: the loss and
    gradients summed over the world (replicas counted once each in the
    sum and the count), equal on every rank, and the JAX trainer's at
    the global batch; the parameters after the step within
    PARAM_ATOL of its, the same bit for bit on every rank; ZeRO-1 on
    equals off bit for bit and shards over dp alone."""
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.utils.pytree import flatten_with_names

    ranks, axes = AXES_CASES[case]
    rng = np.random.RandomState(21)
    n = BATCH[model] * ranks
    shape = (28, 28) if model == "mnist" else (32, 32, 3)
    batch = (rng.rand(n, *shape).astype(np.float32),
             rng.randint(0, 10, size=n).astype(np.int32))
    # The ranks start from their own seeds (rank 0's is the single
    # trainer's), so they run while the JAX reference is computed here.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(launch.spawn, axes_rank, ranks,
                              (model, axes, batch), threads=1,
                              timeout=RANKS_TIMEOUT_S)
        named = port_single(model, n).export_parameters()
        jtrainer = jax_axes_trainer(model, named, ranks, axes)
        _, want_grads = jax.jit(jtrainer._loss_and_grads)(
            jtrainer.params, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
            jnp.ones(n, jnp.float32))
        want_grads = {k: np.asarray(v)
                      for k, v in flatten_with_names(want_grads)[0].items()}
        want_loss = float(jtrainer.train_minibatch(*batch)[0])
        want_report = jtrainer.zero1_report()
        results = spawned.result()
    dp = ranks // int(np.prod(list(axes.values())))
    assert {r["coords"]["dp"] for r in results} == set(range(dp))
    first = results[0][False]
    np.testing.assert_allclose(first["loss"], want_loss, rtol=RTOL)
    assert set(first["grads"]) == set(want_grads)
    for name, g in first["grads"].items():
        np.testing.assert_allclose(g, want_grads[name], err_msg=name,
                                   **GRAD_TOL)
    assert_params_close(first["params"], jtrainer.export_parameters(),
                        PARAM_ATOL)
    assert first["report"] == want_report
    for r in results:
        for zero1 in (False, True):
            got = r[zero1]
            assert got["counts"] == (ranks, 1)
            assert got["loss"] == first["loss"]
            assert _same_state((got["params"], {}, 0),
                               (first["params"], {}, 0))
            assert all(np.array_equal(got["grads"][k], first["grads"][k])
                       for k in first["grads"])
        report = r[True]["report"]
        assert report["num_shards"] == dp
        assert report["mode"] == ("zero1" if dp > 1 else "replicated")


def own_rows_rank(model, batch):
    """A rank of a (dp=1, tp=2) world fed rows of its own: rank r trains
    on half r of ``batch`` from its own seed (it adopts rank 0's
    state)."""
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    mesh = build_mesh(tp=2, backend=tdist.BACKEND, device="cpu")
    rank, b = dist.get_rank(), len(batch[0]) // 2
    trainer = CollectiveTrainer(port_spec(model), batch_size=b, device="cpu",
                                rng_seed=rank, mesh=mesh)
    xs, ys = batch
    loss = float(trainer.train_minibatch(xs[rank * b:(rank + 1) * b],
                                         ys[rank * b:(rank + 1) * b])[0])
    return {"loss": loss, "params": trainer.export_parameters()}


def test_replicas_fed_rows_of_their_own_take_one_step():
    """Replicas (one dp coordinate, tp=2) fed rows of their own, as the
    worker's task stream feeds them: the step is summed over the whole
    world, so both ranks take the mean step over all their rows, the
    single trainer's on the concatenated rows within the file's
    tolerances, and stay bit for bit one another."""
    model = "mnist"
    batch = global_batches(model, 1, seed=23, partial_last=False)[0]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(launch.spawn, own_rows_rank, 2, (model, batch),
                              threads=1, timeout=RANKS_TIMEOUT_S)
        single = port_single(model, len(batch[0]))
        want = float(single.train_minibatch(*batch)[0])
        r0, r1 = spawned.result()
    assert r0["loss"] == r1["loss"]
    assert _same_state((r0["params"], {}, 0), (r1["params"], {}, 0))
    np.testing.assert_allclose(r0["loss"], want, rtol=RTOL)
    assert_params_close(r0["params"], single.export_parameters(), PARAM_ATOL)


def reform_rank(model, role, epochs, batches):
    """A rank of the worlds 4 -> 2 -> 4 under ``elastic_mesh_builder(tp=
    2)`` with ZeRO-1 on: "a0" and "a2" (ranks 0 and 2 of the first world,
    one of each dp coordinate, so the world of 2 holds both shards) stay
    throughout; "b1" and "b3" leave after the first; "j2" and "j3" join the
    last from other seeds.  Each world takes one step on its rows."""
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    build = tdist.elastic_mesh_builder(tp=2, device="cpu", timeout_secs=60)
    b = 2 * BATCH[model]

    def state(t):
        opt = t._whole_state()     # every rank of dp gathers together
        return (t.export_parameters(),
                {k: np.asarray(v.detach().numpy() if hasattr(v, "detach")
                               else v) for k, v in opt.items()}, t.version)

    def step(t, mesh, batch):
        """A step on the first b x dp rows: b a dp coordinate."""
        dp, at = mesh.shape["dp"], mesh.coords["dp"]
        xs, ys = batch
        rows = dp_rows((xs[:b * dp], ys[:b * dp]), at, dp)
        return float(t.train_minibatch(*rows)[0])

    out = {}
    first, then = {"a0": 0, "b1": 1, "a2": 2, "b3": 3}, {"a0": 0, "a2": 1}
    if role in ("j2", "j3"):
        trainer = CollectiveTrainer(port_spec(model), batch_size=b,
                                    device="cpu", zero1=True, rng_seed=11)
        mesh = build(int(role[1]), 4, epochs[2])
        trainer.rebuild(mesh)
        out["adopted"] = state(trainer)
        out["loss"] = step(trainer, mesh, batches[2])
        out["after"] = state(trainer)
        tdist.reset_single_process()
        return out
    mesh = build(first[role], 4, epochs[0])
    trainer = CollectiveTrainer(port_spec(model), batch_size=b, device="cpu",
                                zero1=True, mesh=mesh)
    out["report4"] = trainer.zero1_report()
    step(trainer, mesh, batches[0])
    out["world4"] = state(trainer)
    trainer.snapshot_to_host()
    if role not in then:
        tdist.reset_single_process()
        return out
    mesh = build(then[role], 2, epochs[1])        # (dp=1, tp=2)
    trainer.rebuild(mesh)
    out["report2"] = trainer.zero1_report()
    out["world2_kept"] = _same_state(state(trainer), out["world4"])
    step(trainer, mesh, batches[1])
    out["world2"] = state(trainer)
    trainer.snapshot_to_host()
    mesh = build(then[role], 4, epochs[2])        # (dp=2, tp=2) again
    trainer.rebuild(mesh)
    out["world4_kept"] = _same_state(state(trainer), out["world2"])
    out["loss"] = step(trainer, mesh, batches[2])
    out["after"] = state(trainer)
    tdist.reset_single_process()
    return out


def test_elastic_mesh_reform_4_2_4():
    """4 -> 2 -> 4 under ``elastic_mesh_builder(tp=2)``, ZeRO-1 on: the
    survivors' parameters, AdamW moments, counts and version carried bit
    for bit across both re-forms (the shards over dp put back together,
    whole at dp=1, cut again at dp=2); the joiners adopt rank 0's state
    bit for bit and every rank takes the same step."""
    model = "mnist"
    batches = global_batches(model, 3, seed=17, partial_last=False)
    batches = [(np.concatenate([xs, xs[::-1]]), np.concatenate([ys, ys[::-1]]))
               for xs, ys in batches]              # 4B rows: 2B a dp rank
    svcs = [tdist.MasterCoordinationService(reap_secs=120) for _ in range(3)]
    epochs = [svc.start_epoch(n) for svc, n in zip(svcs, (4, 2, 4))]
    roles = ("a0", "b1", "a2", "b3", "j2", "j3")
    out = dict(zip(roles, launch.run(
        [(reform_rank, (model, role, epochs, batches)) for role in roles],
        timeout=RANKS_TIMEOUT_S, threads=1)))
    a0, a2 = out["a0"], out["a2"]
    for r in ("b1", "a2", "b3"):
        assert _same_state(out[r]["world4"], a0["world4"])
    assert a0["report4"]["num_shards"] == 2 and a0["report4"]["mode"] == \
        "zero1"
    assert a0["report2"]["num_shards"] == 1
    assert a0["world2_kept"] and a2["world2_kept"]
    assert a0["world4_kept"] and a2["world4_kept"]
    assert a0["world2"][2] == 2 and _same_state(a2["world2"], a0["world2"])
    for r in ("j2", "j3"):
        assert _same_state(out[r]["adopted"], a0["world2"])
    for r in ("a2", "j2", "j3"):
        assert out[r]["loss"] == a0["loss"]
        assert _same_state(out[r]["after"], a0["after"])
    assert a0["after"][2] == 3


def test_elastic_mesh_builder_refuses_a_world_it_cannot_split():
    """A world the fixed axes do not divide raises ValueError before it
    forms, as the JAX ``build_mesh`` does; a world of one trains alone."""
    build = tdist.elastic_mesh_builder(tp=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        build(0, 3, "tcpstore://localhost:1")
    assert build(0, 1, "") is None
