"""The port's servable path (elasticdl_tpu_torch/serving) on the CPU:
a JAX-written export predicts the same through the port's loader, and
the port's HTTP server answers the TF-Serving REST surface.

Tolerance against the JAX servable: 1e-4 abs/rel on the logits, as in
test_torch_resnet.py (float32 on both sides, convs summed in different
orders).
"""

import http.client
import json
import os
import threading

import numpy as np
import pytest

from elasticdl_tpu.serving.export import export_servable as jax_export
from elasticdl_tpu.serving.loader import load_servable as jax_load
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.serving import server as tserver
from tests.test_torch_resnet import random_named

ZOO = ("resnet", "variant=resnet_small_cifar10")


def _images(n, seed=3):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(
        np.float32)


def _port_export(path, seed=0, version=0):
    _, _, named = random_named("resnet_small_cifar10", 32, seed=seed)
    spec = load_model_spec(*ZOO)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    return texport.export_servable(
        str(path), ZOO[0], ZOO[1], module, _images(1), model_name="rn",
        version=version)


def test_port_loader_serves_a_jax_export(tmp_path):
    jspec, params, _ = random_named("resnet_small_cifar10", 32)
    jax_export(str(tmp_path), lambda p, x: jspec.apply_fn(p, x, False),
               params, _images(1), model_name="rn", version=3,
               platforms=("cpu",))
    x = _images(3)
    want = np.asarray(jax_load(str(tmp_path)).predict(x))
    with pytest.raises(ValueError, match="zoo"):
        tloader.load_servable(str(tmp_path), device="cpu")
    model = tloader.load_servable(str(tmp_path), device="cpu", zoo=ZOO)
    got = model.predict(x)
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert model.dummy_inputs(5).shape == (5, 32, 32, 3)


class _Served:
    def __init__(self, endpoint):
        self.server = tserver.build_server(endpoint, port=0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def served():
    made = []

    def start(endpoint):
        made.append(_Served(endpoint))
        return made[-1]

    yield start
    for s in made:
        s.close()


def test_server_rest_surface(tmp_path, served):
    manifest = _port_export(tmp_path / "export", version=7)
    assert manifest["format"] == "elasticdl_tpu_torch_servable_v1"
    assert manifest["zoo"] == {"module": "resnet",
                               "model_params": ZOO[1]}
    s = served(tserver.ModelEndpoint(str(tmp_path / "export"),
                                     device="cpu"))
    x = _images(2)
    want = tloader.load_servable(str(tmp_path / "export"),
                                 device="cpu").predict(x)
    for key in ("instances", "inputs"):
        code, out = s.request("POST", "/v1/models/rn:predict",
                              json.dumps({key: x.tolist()}))
        assert code == 200 and out["model_version"] == 7
        np.testing.assert_allclose(out["predictions"], want,
                                   atol=1e-6, rtol=1e-6)
    code, meta = s.request("GET", "/v1/models/rn")
    assert code == 200
    assert meta["model_version_status"][0]["version"] == "7"
    assert meta["metadata"]["input_signature"]["shape"] == [None, 32, 32, 3]
    assert s.request("GET", "/v1/models/rn/metadata")[0] == 200
    assert s.request("GET", "/healthz") == (200, {"status": "ok"})
    assert s.request("POST", "/v1/models/rn:predict", b"{not json")[0] \
        == 400
    assert s.request("POST", "/v1/models/rn:predict",
                     json.dumps({"rows": []}))[0] == 400
    assert s.request("POST", "/v1/models/rn:predict",
                     json.dumps({"instances": [[1.0, 2.0]]}))[0] == 400
    assert s.request("GET", "/v1/models/other")[0] == 404
    assert s.request("POST", "/v1/models/other:predict", b"{}")[0] == 404
    # No Content-Length: refused with 411, never read as the next request.
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
    conn.putrequest("POST", "/v1/models/rn:predict")
    conn.endheaders()
    assert conn.getresponse().status == 411
    conn.close()


def test_versioned_base_serves_newest_complete_version(tmp_path, served):
    base = tmp_path / "base"
    _port_export(base / "1", seed=0, version=1)
    _port_export(base / "2", seed=1, version=2)
    os.makedirs(base / "5")                      # torn: no manifest
    os.makedirs(base / "6.tmp-123")              # staging leftover
    assert tloader.list_versions(str(base)) == [1, 2]
    s = served(tserver.ModelEndpoint(str(base), device="cpu",
                                     poll_interval=0.0))
    body = json.dumps({"instances": _images(1).tolist()})
    code, out = s.request("POST", "/v1/models/rn:predict", body)
    assert code == 200 and out["model_version"] == 2
    _port_export(base / "3", seed=2, version=3)
    code, out = s.request("POST", "/v1/models/rn:predict", body)
    assert code == 200 and out["model_version"] == 3
    want = tloader.load_servable(str(base / "3"), device="cpu").predict(
        _images(1))
    np.testing.assert_allclose(out["predictions"], want, atol=1e-6,
                               rtol=1e-6)
