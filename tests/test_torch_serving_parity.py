"""The port's batching server against the JAX package's, on the CPU.

The same ``resnet_small_cifar10`` weights are exported by each package
(the JAX one as a StableHLO servable, the port's as its npz + zoo entry)
and served by each package's batching ``ModelEndpoint``.  Eight
concurrent requests of 1-3 images go to both; each request's
predictions agree within 1e-4 abs/rel, the tolerance of
test_torch_serving.py (float32 on both sides, convs summed in different
orders, rows batched into whatever bucket their neighbours make).

A JAX-written export with an embedding table answers ``:lookup``
through the port's loader bit for bit as through the JAX loader,
unknown and repeated ids included.
"""

import threading

import numpy as np

from elasticdl_tpu.serving.batcher import BatchConfig as JaxBatchConfig
from elasticdl_tpu.serving.export import export_servable as jax_export
from elasticdl_tpu.serving.loader import load_servable as jax_load
from elasticdl_tpu.serving.server import ModelEndpoint as JaxEndpoint
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.serving.batcher import BatchConfig
from elasticdl_tpu_torch.serving.server import ModelEndpoint
from tests import torch_serving_zoo as zoo
from tests.test_torch_resnet import random_named

ZOO = ("resnet", "variant=resnet_small_cifar10")


def _concurrently(endpoint, bodies):
    out = [None] * len(bodies)
    errors = []

    def hit(k):
        try:
            out[k] = endpoint.predict(bodies[k])["predictions"]
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=hit, args=(k,))
               for k in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return out


def test_batched_predictions_match_the_jax_server(tmp_path):
    jspec, params, named = random_named("resnet_small_cifar10", 32)
    example = np.zeros((1, 32, 32, 3), np.float32)
    jax_export(str(tmp_path / "jax"), lambda p, x: jspec.apply_fn(p, x, False),
               params, example, model_name="rn", platforms=("cpu",))
    spec = load_model_spec(*ZOO)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    manifest = texport.export_servable(str(tmp_path / "port"), ZOO[0],
                                       ZOO[1], module, example,
                                       model_name="rn")
    assert manifest["polymorphic_batch"] is True
    assert manifest["output_signature"] == {"shape": [None, 10],
                                            "dtype": "float32"}
    rng = np.random.RandomState(5)
    bodies = [{"instances": rng.randn(1 + k % 3, 32, 32, 3).astype(
        np.float32).tolist()} for k in range(8)]
    # The JAX endpoint pads every batch to 8 (one XLA compile); the
    # port's pads to its default buckets 1, 2, 4, 8.
    jax_endpoint = JaxEndpoint(str(tmp_path / "jax"), batching=JaxBatchConfig(
        max_batch_size=8, batch_timeout_ms=100.0, pad_buckets=[8],
        warm=False))
    port_endpoint = ModelEndpoint(
        str(tmp_path / "port"), device="cpu", batching=BatchConfig(
            max_batch_size=8, batch_timeout_ms=100.0, warm=False))
    try:
        want = _concurrently(jax_endpoint, bodies)
        got = _concurrently(port_endpoint, bodies)
        counters = port_endpoint.timing.counters()
    finally:
        jax_endpoint.close()
        port_endpoint.close()
    assert counters["batcher.batches"] < counters["batcher.requests"] == 8
    for k, body in enumerate(bodies):
        assert np.shape(got[k]) == (len(body["instances"]), 10)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)


def test_port_loader_looks_up_a_jax_export_like_the_jax_loader(tmp_path):
    rng = np.random.RandomState(0)
    w = np.arange(8, dtype=np.float32).reshape(4, 2)
    ids = np.array([40, 7, 19, 7, 3])           # 7 twice: the last row wins
    values = rng.randn(5, 6).astype(np.float32)
    jax_export(str(tmp_path), lambda p, x: x @ p["w"], {"w": w},
               np.zeros((1, 4), np.float32), model_name="lin",
               embeddings={"users": (ids, values)}, platforms=("cpu",))
    probe = np.array([7, 3, 999, 40, -1, 19, 7])
    want = jax_load(str(tmp_path)).lookup_embedding("users", probe)
    model = tloader.load_servable(str(tmp_path), device="cpu",
                                  zoo=(zoo.MODULE, "kind=linear"))
    got = model.lookup_embedding("users", probe)
    assert got.dtype == want.dtype and got.shape == (7, 6)
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(got[2], np.zeros(6, np.float32))
    np.testing.assert_array_equal(model.predict(np.ones((1, 4), np.float32)),
                                  [[12.0, 16.0]])
