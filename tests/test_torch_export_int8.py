"""int8 servables and the train-end exporter on the CPU: twins of
tests/test_serving_export.py's int8 cases and of tests/test_callbacks.py.

The port's payload codec (``serving/export.py``: ``_quantize_int8``,
``_encode_embeddings``, ``decode_payload``) is numpy and must write the
JAX package's bytes: the payloads are compared array for array, bitwise,
and each package's ``load_export`` reads the other's int8 export
bitwise.  ``ModelExporter`` (``models/callbacks.py``) is held to the
reference's roundtrip, PS-checkpoint merge (through the shards' half of
the port's checkpoint saver) and stale-dense rule.

The int8 serving tolerances: an int8 export of the reference test's
``x @ w + b`` ([256, 128] weights, inputs ~N(0, 1)) answers within 0.6
absolute and 5e-2 relative of its float32 export, the reference test's
bound.  A ResNet's int8 rows are held within INT8_REL_TOL (0.1) of
max|logit| of its float32 rows, row by row: resnet_small_cifar10 with
He-scaled random weights measures 0.0217 here (and ResNet-50 at 64x64
0.0312 with the same code), so the bound leaves 3x room.
chip_smoke.py phase 24 holds ResNet-50's int8 rows on the card to the
same bound.
"""

import json
import os

import numpy as np
import pytest

from elasticdl_tpu.models import callbacks as jcallbacks
from elasticdl_tpu.serving import export as jexport
from elasticdl_tpu.serving.loader import load_servable as jax_load
from elasticdl_tpu_torch.models import callbacks as tcallbacks
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from tests import torch_serving_zoo as zoo


def _flat(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(256, 128).astype(np.float32),
            "b": rng.randn(128).astype(np.float32),
            "small": rng.randn(8, 8).astype(np.float32),
            "ids_like": rng.randint(0, 9, (64, 128)).astype(np.int32),
            "f64": rng.randn(64, 128)}


def _tables(seed=1):
    rng = np.random.RandomState(seed)
    return {"items": (np.arange(1024), rng.randn(1024, 16).astype(
        np.float32)),
            "tiny": (np.array([5, 9, 11]), rng.randn(3, 4).astype(
                np.float32))}


def test_int8_payload_is_the_reference_bytes():
    flat = _flat()
    got, got_q = texport._quantize_int8(flat)
    want, want_q = jexport._quantize_int8(flat)
    assert got_q == want_q == ["w"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key
    tp, jp = {}, {}
    assert (texport._encode_embeddings(tp, _tables(), "int8")
            == jexport._encode_embeddings(jp, _tables(), "int8"))
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tp[key].tobytes() == jp[key].tobytes(), key
    # The npz archives of the same payload are the same bytes too.
    assert texport._npz_bytes(got) == jexport._npz_bytes(want)


def _port_int8_export(path):
    rng = np.random.RandomState(0)
    w = rng.randn(256, 128).astype(np.float32)
    return zoo.export(path, {"w": w}, np.zeros((1, 256), np.float32),
                      quantize="int8", embeddings=_tables()), w


def test_each_load_export_reads_the_others_int8_export(tmp_path):
    manifest, _ = _port_int8_export(tmp_path / "port")
    assert manifest["format"] == (
        "int8-emb+int8-weights+" + texport.FORMAT)
    assert manifest["quantized_int8"] == ["emb:items", "w"]
    jexport.export_servable(
        str(tmp_path / "jax"), lambda p, x: x @ p["w"],
        {"w": np.random.RandomState(0).randn(256, 128).astype(np.float32)},
        np.zeros((1, 256), np.float32), platforms=("cpu",),
        quantize="int8", embeddings=_tables())
    for path in ("port", "jax"):
        td, te = tcallbacks.load_export(str(tmp_path / path))
        jd, je = jcallbacks.load_export(str(tmp_path / path))
        assert sorted(td) == sorted(jd) == ["w"]
        assert td["w"].tobytes() == jd["w"].tobytes()
        assert sorted(te) == sorted(je) == ["items", "tiny"]
        for name in je:
            for a, b in zip(te[name], je[name]):
                assert a.tobytes() == b.tobytes()
    # Both packages wrote the same quantized weights and tables.
    assert (tcallbacks.load_export(str(tmp_path / "port"))[0]["w"].tobytes()
            == jcallbacks.load_export(str(tmp_path / "jax"))[0]["w"]
            .tobytes())


def test_int8_export_serves_within_the_quantization_bound(tmp_path):
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(256, 128).astype(np.float32)}
    x = rng.randn(4, 256).astype(np.float32)
    zoo.export(tmp_path / "f32", params, np.zeros((1, 256), np.float32))
    manifest = zoo.export(tmp_path / "q8", params,
                          np.zeros((1, 256), np.float32), quantize="int8")
    assert manifest["quantized_int8"] == ["w"]
    size_f32 = os.path.getsize(tmp_path / "f32" / "model.npz")
    size_q8 = os.path.getsize(tmp_path / "q8" / "model.npz")
    assert size_q8 < 0.35 * size_f32, (size_q8, size_f32)
    # The program is the float32 one: int8 is storage only.
    assert (tmp_path / "q8" / "model.pt2").read_bytes() == (
        tmp_path / "f32" / "model.pt2").read_bytes()
    want = tloader.load_servable(str(tmp_path / "f32"),
                                 device="cpu").predict(x)
    got = tloader.load_servable(str(tmp_path / "q8"),
                                device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.6)
    assert np.abs(got - want).max() > 1e-4  # it really quantized


def test_int8_tables_dequantize_for_lookup(tmp_path):
    _port_int8_export(tmp_path / "e")
    big = _tables()["items"][1]
    model = tloader.load_servable(str(tmp_path / "e"), device="cpu")
    np.testing.assert_allclose(model.lookup_embedding("items", [0, 7, 1023]),
                               big[[0, 7, 1023]], rtol=0.02, atol=0.05)
    np.testing.assert_array_equal(model.lookup_embedding("tiny", [9]),
                                  _tables()["tiny"][1][[1]])


def test_jax_int8_export_loads_in_the_port_with_zoo(tmp_path):
    rng = np.random.RandomState(3)
    w = rng.randn(256, 128).astype(np.float32)
    jexport.export_servable(
        str(tmp_path / "e"), lambda p, x: x @ p["w"], {"w": w},
        np.zeros((1, 256), np.float32), platforms=("cpu",),
        quantize="int8")
    with pytest.raises(ValueError, match="zoo"):
        tloader.load_servable(str(tmp_path / "e"), device="cpu")
    x = rng.randn(3, 256).astype(np.float32)
    got = tloader.load_servable(
        str(tmp_path / "e"), device="cpu",
        zoo=(zoo.MODULE, "kind=linear;bias=0.0;n_in=256;n_out=128")
    ).predict(x)
    want = np.asarray(jax_load(str(tmp_path / "e")).predict(x))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


INT8_REL_TOL = 0.1


def test_int8_resnet_rows_within_the_stated_bound(tmp_path):
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from tests.test_torch_resnet import random_named

    _, _, named = random_named("resnet_small_cifar10", 32)
    params = "variant=resnet_small_cifar10"
    spec = load_model_spec("resnet", params)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    x = np.random.RandomState(1).rand(8, 32, 32, 3).astype(np.float32)
    rows = {}
    for sub, quantize in (("f32", None), ("q8", "int8")):
        texport.export_servable(str(tmp_path / sub), "resnet", params,
                                module, x[:1], quantize=quantize)
        rows[sub] = tloader.load_servable(str(tmp_path / sub),
                                          device="cpu").predict(x)
    f32, q8 = rows["f32"], rows["q8"]
    rel = np.abs(q8 - f32).max(axis=1) / np.abs(f32).max(axis=1)
    assert 1e-4 < rel.max() < INT8_REL_TOL, rel
    assert (q8.argmax(axis=1) == f32.argmax(axis=1)).all()


# -- models/callbacks.py (twin of tests/test_callbacks.py) ----------------


def _trained(steps=1):
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=8,
                                device="cpu")
    xs, ys = mnist.synthetic_data(n=8)
    for _ in range(steps):
        trainer.train_minibatch(xs, ys)
    return trainer, xs


def test_model_exporter_roundtrip(tmp_path):
    trainer, xs = _trained()
    export_dir = str(tmp_path / "export")
    tcallbacks.ModelExporter(export_dir, model_name="mnist").on_train_end(
        trainer)
    with open(os.path.join(export_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["model_name"] == "mnist"
    assert manifest["program"] == "model.pt2"
    assert manifest["version"] == 1
    dense, _ = tcallbacks.load_export(export_dir)
    live = trainer.export_parameters()
    assert set(dense) == set(live)
    for k in live:
        np.testing.assert_array_equal(dense[k], live[k])
    served = tloader.load_servable(export_dir, device="cpu")
    np.testing.assert_allclose(served.predict(xs), trainer.predict_minibatch(
        xs), atol=1e-5, rtol=1e-5)


def test_model_exporter_versioned_and_int8(tmp_path):
    trainer, _ = _trained(steps=2)
    tcallbacks.ModelExporter(str(tmp_path), versioned=True,
                             quantize="int8").on_train_end(trainer)
    manifest = json.loads((tmp_path / "2" / "manifest.json").read_text())
    assert manifest["format"].startswith("int8-weights+")
    assert "Dense_0/kernel" in manifest["quantized_int8"]
    tloader.load_servable(str(tmp_path), device="cpu")


def test_model_exporter_merges_ps_checkpoint(tmp_path):
    ckpt = CheckpointSaver(str(tmp_path / "ckpt"))
    for shard in range(2):
        ckpt.save_shard(
            5, shard, 2,
            dense={"ps_only/w%d" % shard: np.ones(3, np.float32)},
            embeddings={"table": (np.array([1 + shard]),
                                  np.ones((1, 4), np.float32)),
                        "slot:table:m": (np.array([1 + shard]),
                                         np.zeros((1, 4), np.float32))})
    # No minibatch fixed a signature: the weights-only export, with
    # the checkpoint's dense arrays merged in (the reference's case).
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=8,
                                device="cpu")
    export_dir = str(tmp_path / "export")
    tcallbacks.ModelExporter(
        export_dir, checkpoint_dir=str(tmp_path / "ckpt")
    ).on_train_end(trainer)
    dense, embeddings = tcallbacks.load_export(export_dir)
    assert "ps_only/w0" in dense and "ps_only/w1" in dense
    assert sorted(embeddings) == ["table"]
    ids, _values = embeddings["table"]
    assert sorted(ids.tolist()) == [1, 2]
    # A servable export carries the merged tables beside its program.
    trainer, _ = _trained()
    tcallbacks.ModelExporter(
        str(tmp_path / "servable"), checkpoint_dir=str(tmp_path / "ckpt")
    ).on_train_end(trainer)
    served = tloader.load_servable(str(tmp_path / "servable"), device="cpu")
    np.testing.assert_array_equal(served.lookup_embedding("table", [2, 1]),
                                  np.ones((2, 4), np.float32))


def test_model_exporter_skips_stale_checkpoint_dense(tmp_path):
    trainer, _ = _trained()
    live = dict(trainer.export_parameters())
    name = sorted(live)[0]
    assert trainer.version > 0
    ckpt = CheckpointSaver(str(tmp_path / "ckpt"))
    ckpt.save(0, dense={name: np.zeros_like(live[name])})
    export_dir = str(tmp_path / "export")
    tcallbacks.ModelExporter(
        export_dir, checkpoint_dir=str(tmp_path / "ckpt")
    ).on_train_end(trainer)
    dense, _ = tcallbacks.load_export(export_dir)
    np.testing.assert_array_equal(dense[name], live[name])  # not zeros
    # A checkpoint at the trainer's version is authoritative.
    ckpt.save(trainer.version, dense={name: np.zeros_like(live[name])})
    tcallbacks.ModelExporter(
        str(tmp_path / "export2"), checkpoint_dir=str(tmp_path / "ckpt")
    ).on_train_end(trainer)
    dense2, _ = tcallbacks.load_export(str(tmp_path / "export2"))
    np.testing.assert_array_equal(dense2[name], np.zeros_like(live[name]))


def test_lr_scheduler_sets_ps_trainer_lr():
    class FakeTrainer:
        version = 100
        _learning_rate = 0.0

    scheduler = tcallbacks.LearningRateScheduler(
        lambda version: 0.1 if version < 50 else 0.01)
    trainer = FakeTrainer()
    assert scheduler.on_train_batch_begin(trainer) == 0.01
    assert trainer._learning_rate == 0.01
