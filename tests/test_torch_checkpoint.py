"""The port's CheckpointSaver (elasticdl_tpu_torch/utils/checkpoint.py)
against the JAX package's on the same directories: what one writes the
other reads, bit for bit, and both agree on which versions are valid."""

import numpy as np
import pytest

from elasticdl_tpu.utils.checkpoint import CheckpointSaver as JSaver
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver


def _dense(seed):
    rng = np.random.RandomState(seed)
    return {
        "Conv_0/kernel": rng.randn(3, 3, 3, 8).astype(np.float32),
        "GroupNorm_0/scale": rng.rand(8).astype(np.float32),
        "opt/0/count": np.asarray(seed, np.int32),
    }


def _assert_same(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_port_checkpoint_loads_in_the_jax_saver(tmp_path):
    CheckpointSaver(str(tmp_path)).save(4, _dense(4))
    dense, embeddings, version = JSaver(str(tmp_path)).load()
    assert version == 4 and embeddings == {}
    _assert_same(dense, _dense(4))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_jax_checkpoint_loads_in_the_port(tmp_path, num_shards):
    JSaver(str(tmp_path)).save(6, dense=_dense(6), num_shards=num_shards)
    dense, version = CheckpointSaver(str(tmp_path)).load()
    assert version == 6
    _assert_same(dense, _dense(6))


def test_gc_keeps_the_newest_versions(tmp_path):
    saver = CheckpointSaver(str(tmp_path), keep_max=2)
    for version in range(1, 6):
        saver.save(version, _dense(version))
    assert saver.versions() == [4, 5]
    assert JSaver(str(tmp_path)).versions() == [4, 5]
    _assert_same(saver.load(4)[0], _dense(4))


def test_torn_version_is_skipped(tmp_path):
    saver = CheckpointSaver(str(tmp_path))
    saver.save(3, _dense(3))
    # One of two shard files of version 7: a torn write.
    JSaver(str(tmp_path)).save_shard(7, 0, 2, dense=_dense(7))
    assert not saver.is_valid_version(7)
    assert saver.latest_version() == 3
    _assert_same(saver.load()[0], _dense(3))
    with pytest.raises(FileNotFoundError, match="torn"):
        saver.load(7)


def test_missing_and_embedding_checkpoints_are_refused(tmp_path):
    saver = CheckpointSaver(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        saver.load()
    ids = np.arange(4, dtype=np.int64)
    JSaver(str(tmp_path)).save(
        1, dense=_dense(1),
        embeddings={"table": (ids, np.ones((4, 2), np.float32))})
    with pytest.raises(ValueError, match="dense arrays only"):
        saver.load()
