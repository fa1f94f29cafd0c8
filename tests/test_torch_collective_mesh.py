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

Ranks are spawned processes (``parallel/launch.py``: ``spawn`` for a
fixed world, ``run`` for the re-formed ones), under a time limit; this
module imports JAX only in the test process, inside the tests.
"""

import numpy as np
import pytest
import torch.distributed as dist

from elasticdl_tpu_torch.parallel import distributed as tdist
from elasticdl_tpu_torch.parallel import launch

RTOL = 2e-4
PARAM_ATOL = 1e-4
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
