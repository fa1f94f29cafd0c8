"""The parameter-server checkpoint format is shared by the two packages.

``utils/checkpoint.py``'s shard half (``save_shard``, ``load_shard``,
``shard_versions``, ``truncate_shard_after``,
``latest_resumable_version`` and per-shard GC) keeps the JAX package's
file names and npz layouts: a checkpoint that one package's PS shards
write, a relaunched shard of the other package restores, its dense
parameters, embedding rows and optimizer slots (dense Adam m, v and
step; the embedding slot tables) bit for bit, and the next push then
lands where it lands on a fleet that never stopped, within float32
rounding (the packages build their native kernels with other flags).

The savers alone are held to each other on one scripted history of
per-shard writes (drifted labels, a resize, GC under ``keep_max``, a
rollback): after each step both directories hold the same files, and
each package reads the other's directory to the same committed label
and the same arrays.
"""

import os

import numpy as np
import pytest

from elasticdl_tpu.ps import server as jserver
from elasticdl_tpu.utils import args as jargs
from elasticdl_tpu.utils import checkpoint as jckpt
from elasticdl_tpu.utils import grpc_utils as jgrpc
from elasticdl_tpu.worker import ps_client as jclient
from elasticdl_tpu_torch.ps import server
from elasticdl_tpu_torch.utils import args, checkpoint, grpc_utils
from elasticdl_tpu_torch.worker import ps_client

PORT = (server, args, grpc_utils, ps_client)
JAX = (jserver, jargs, jgrpc, jclient)
INFOS = [{"name": "emb", "dim": 3, "initializer": "uniform"},
         {"name": "lin", "dim": 1, "initializer": "zeros"}]


def start_fleet(pkg, ckpt, restore=False, num_ps=2):
    """``num_ps`` shards of one package (Adam, a checkpoint every
    version) and a client over them."""
    srv, argmod, grpc, client = pkg
    shards, channels = [], []
    for i in range(num_ps):
        argv = ["--port", "0", "--ps_id", str(i), "--num_ps", str(num_ps),
                "--opt_type", "adam", "--opt_args", "learning_rate=0.01",
                "--checkpoint_dir", str(ckpt), "--checkpoint_steps", "1"]
        if restore:
            argv += ["--checkpoint_dir_for_init", str(ckpt)]
        ps = srv.ParameterServer(argmod.parse_ps_args(argv))
        ps.prepare()
        ch = grpc.build_channel("localhost:%d" % ps.port)
        grpc.wait_for_channel_ready(ch)
        shards.append(ps)
        channels.append(ch)
    return shards, client.PSClient(channels)


def push(client, step, version):
    """Step ``step``'s gradients.  Step 3 touches only ids of earlier
    steps: a restored shard re-creates its tables with the default
    initializer (both packages' ``ps/server.py`` ``_restore``), so a new
    id of the zeros-initialized table would start elsewhere there."""
    rng = np.random.RandomState(step)
    ids = np.array([1, 4, 7, 10 + min(step, 2)], np.int64)
    return client.push_gradients(
        {"w0": rng.randn(3, 2).astype(np.float32),
         "b0": rng.randn(2).astype(np.float32),
         "bias": rng.randn(1).astype(np.float32)},
        {"emb": (rng.randn(4, 3).astype(np.float32), ids),
         "lin": (rng.randn(4, 1).astype(np.float32), ids)},
        version=version)


def state(shards):
    """Every shard's parameters, tables, slot tables and dense slots."""
    out = []
    for ps in shards:
        dense, tables = ps.parameters.to_checkpoint_payload()
        slots = ps.optimizer.slots_to_payload()
        tables = {k: (ids[np.argsort(ids)], vals[np.argsort(ids)])
                  for k, (ids, vals) in tables.items()}
        out.append((ps.parameters.version, dense, tables, slots))
    return out


def assert_same(a, b, rtol=0.0):
    assert len(a) == len(b)
    for (va, da, ta, sa), (vb, db, tb, sb) in zip(a, b):
        assert va == vb
        for x, y in ((da, db), (sa, sb)):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_allclose(x[k], y[k], rtol=rtol, atol=0,
                                           err_msg=k)
        assert sorted(ta) == sorted(tb)
        for k in ta:
            for x, y in zip(ta[k], tb[k]):
                np.testing.assert_allclose(x, y, rtol=rtol, atol=0,
                                           err_msg=k)


def stop(shards):
    for ps in shards:
        ps.stop()


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port_to_jax", "jax_to_port"])
def test_shard_checkpoint_restores_across_packages(tmp_path, writer,
                                                   reader):
    ckpt = tmp_path / "ckpt"
    shards, client = start_fleet(writer, ckpt)
    try:
        client.push_model({"w0": np.ones((3, 2), np.float32),
                           "b0": np.zeros(2, np.float32),
                           "bias": np.zeros(1, np.float32)},
                          embedding_infos=INFOS)
        for step in range(3):
            accepted, _ = push(client, step, step)
            assert accepted
        written = state(shards)
    finally:
        stop(shards)
    assert jckpt.CheckpointSaver(str(ckpt)).latest_resumable_version(2) \
        == checkpoint.CheckpointSaver(str(ckpt)).latest_resumable_version(
            2) == 3

    restored, client = start_fleet(reader, ckpt, restore=True)
    try:
        assert_same(state(restored), written)
        # Adam's m, v and step came back: the next push lands where it
        # lands on a fleet that never stopped.
        accepted, _ = push(client, 3, 3)
        assert accepted
        after_restore = state(restored)
    finally:
        stop(restored)
    # The fleet that never stopped runs the writer's native kernels; the
    # two packages compile kernels.cc with other flags (the JAX package
    # with -march=native, which lets g++ fuse multiply-adds), so the
    # push after the restore agrees within float32 rounding, 1e-6.
    straight, client = start_fleet(writer, tmp_path / "straight")
    try:
        client.push_model({"w0": np.ones((3, 2), np.float32),
                           "b0": np.zeros(2, np.float32),
                           "bias": np.zeros(1, np.float32)},
                          embedding_infos=INFOS)
        for step in range(4):
            push(client, step, step)
        assert_same(after_restore, state(straight), rtol=1e-6)
    finally:
        stop(straight)


def _history():
    """(op, args) steps of per-shard writes a fleet goes through."""
    rng = np.random.RandomState(0)

    def payload(shard, n):
        ids = np.arange(shard, 40, n, dtype=np.int64)
        return ({"w%d" % shard: rng.randn(2, 2).astype(np.float32),
                 "optslot/w%d@m" % shard: rng.randn(2, 2).astype(
                     np.float32),
                 "optslot/__step__": np.array([7], np.int64)},
                {"emb": (ids, rng.randn(ids.size, 3).astype(np.float32))})

    steps = []
    for version in (4, 8, 12):
        for shard in (0, 1):
            steps.append(("save", (version, shard, 2) + payload(shard, 2)))
    steps.append(("save", (16, 0, 2) + payload(0, 2)))       # drifted
    steps.append(("truncate", (12, 0, 2)))                    # rollback
    for version in (20, 24):                                  # resize to 3
        for shard in (0, 1, 2):
            steps.append(("save", (version, shard, 3) + payload(shard, 3)))
    return steps


def _apply(saver, op, a):
    if op == "save":
        version, shard, n, dense, emb = a
        saver.save_shard(version, shard, n, dense=dense, embeddings=emb)
    else:
        saver.truncate_shard_after(*a)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_savers_write_and_read_the_same_history(tmp_path):
    ours = checkpoint.CheckpointSaver(str(tmp_path / "port"), keep_max=2)
    ref = jckpt.CheckpointSaver(str(tmp_path / "jax"), keep_max=2)
    for op, a in _history():
        _apply(ours, op, a)
        _apply(ref, op, a)
        assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
        assert ours.versions() == ref.versions()
        for n in (2, 3):
            assert ours.latest_resumable_version(n) == \
                ref.latest_resumable_version(n)
            for shard in range(n):
                assert ours.shard_versions(shard, n) == ref.shard_versions(
                    shard, n)
    # Each package reads the other's directory: the committed label,
    # re-routed to any shard count, with the same arrays.
    for root in ("port", "jax"):
        mine = checkpoint.CheckpointSaver(str(tmp_path / root))
        theirs = jckpt.CheckpointSaver(str(tmp_path / root))
        for n in (1, 2, 3):
            for shard in range(n):
                d1, e1, v1 = mine.load_shard(None, shard, n)
                d2, e2, v2 = theirs.load_shard(None, shard, n)
                assert v1 == v2 == 24
                assert sorted(d1) == sorted(d2)
                for k in d1:
                    np.testing.assert_array_equal(d1[k], d2[k])
                for k in e1:
                    for x, y in zip(e1[k], e2[k]):
                        np.testing.assert_array_equal(x, y)


def test_uncommitted_shard_files_are_refused(tmp_path):
    """Only drifted labels on disk, none complete: both packages refuse
    to restore rather than hand a shard a mixed-version model."""
    for saver_cls in (checkpoint.CheckpointSaver, jckpt.CheckpointSaver):
        root = tmp_path / saver_cls.__module__.split(".")[0]
        saver = saver_cls(str(root))
        saver.save_shard(4, 0, 2, dense={"w": np.ones(2, np.float32)})
        saver.save_shard(8, 1, 2, dense={"w": np.ones(2, np.float32)})
        assert saver.latest_resumable_version(2) is None
        with pytest.raises(FileNotFoundError, match="uncommitted"):
            saver.load_shard(None, 0, 2)
