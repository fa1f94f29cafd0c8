"""The port's twin of tests/test_serving_binary.py: the binary frame
wire on the port's model server (content-type negotiation, JSON-vs-
binary bit-identity under concurrency, per-request bf16 opt-in, loud
refusal of malformed frames) and the port's router (a byte-identical
copy of the reference's): keyed placement off the frame header only,
forwarded bodies byte-identical, content type preserved, zero
re-encode; and the router in front of two port replicas.

The model is the reference tests' exact ``x @ W`` as a test-only zoo
entry (``tests/torch_serving_zoo.py``), served on the CPU."""

import json
import threading
import time
import http.client
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from elasticdl_tpu_torch.serving.batcher import BatchConfig
from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server
from elasticdl_tpu_torch.utils import tensor_codec as tc
from tests import torch_serving_zoo as zoo

W = np.arange(8, dtype=np.float32).reshape(4, 2)
EMB = (np.array([5, 9]),
       np.arange(8, dtype=np.float32).reshape(2, 4))


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("exports") / "lin"
    zoo.export(
        path, {"w": W}, np.zeros((1, 4), np.float32), model_name="lin",
        version=3, embeddings={"users": EMB},
    )
    return str(path)


@pytest.fixture(scope="module")
def served(export_dir):
    endpoint = ModelEndpoint(
        export_dir, device="cpu",
        batching=BatchConfig(max_batch_size=8, batch_timeout_ms=5.0,
                             warm=False))
    server = build_server(endpoint, port=0)
    thread = threading.Thread(target=server.serve_forever,
                              daemon=True)
    thread.start()
    yield endpoint, server.server_address[1]
    server.shutdown()
    server.server_close()
    endpoint.close()


def _post(port, path, body, content_type=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    try:
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Content-Type")
    finally:
        conn.close()


def _predict_binary(port, x, meta=None):
    blob = tc.encode_frame({"instances": x}, kind="predict",
                           meta=meta)
    return _post(port, "/v1/models/lin:predict", blob,
                 tc.FRAME_CONTENT_TYPE)


def test_json_and_binary_responses_bit_identical(served):
    _, port = served
    x = np.random.RandomState(1).randn(4, 4).astype(np.float32)
    status, raw, _ = _post(port, "/v1/models/lin:predict",
                           json.dumps({"instances": x.tolist()}))
    assert status == 200
    jout = json.loads(raw)
    status, raw, ctype = _predict_binary(port, x)
    assert status == 200
    assert ctype == tc.FRAME_CONTENT_TYPE
    frame = tc.decode_frame(raw)
    preds = tc.unflatten_tree(frame.meta["tree"], frame.tensors)
    assert preds.dtype == np.float32
    # Bit-identical to the JSON fallback on the same model.
    assert np.array_equal(
        preds, np.asarray(jout["predictions"], np.float32))
    assert frame.model_version == jout["model_version"] == 3


def test_bit_identity_under_concurrency(served):
    """8 client threads mixing both content types against the SAME
    batcher admission queue: every binary response must equal the JSON
    response for the same row, and version stamps never diverge —
    coalescing is content-type-blind.

    The rows are small integers: with the integer weights every product
    and sum is exact in float32, so a row's answer cannot depend on the
    bucket it was batched into.  (With random floats, as the reference
    test has them, a row's bits may differ between buckets: the
    reference fails its own case on XLA's CPU backend for that reason.)
    The invariant held here is the batcher's: both content types go
    through one queue and get the same answer."""
    _, port = served
    rng = np.random.RandomState(7)
    rows = rng.randint(-8, 9, (8, 4)).astype(np.float32)
    errors = []
    barrier = threading.Barrier(8)

    def client(idx):
        x = rows[idx:idx + 1]
        raw_json = json.dumps({"instances": x.tolist()})
        blob = tc.encode_frame({"instances": x}, kind="predict")
        try:
            barrier.wait(timeout=30)
            for _ in range(10):
                s1, r1, _ = _post(port, "/v1/models/lin:predict",
                                  raw_json)
                s2, r2, _ = _post(port, "/v1/models/lin:predict",
                                  blob, tc.FRAME_CONTENT_TYPE)
                assert s1 == 200 and s2 == 200
                jout = json.loads(r1)
                frame = tc.decode_frame(r2)
                preds = tc.unflatten_tree(frame.meta["tree"],
                                          frame.tensors)
                if not np.array_equal(
                        preds,
                        np.asarray(jout["predictions"], np.float32)):
                    errors.append("row %d mismatch" % idx)
                if frame.model_version != jout["model_version"]:
                    errors.append("version mismatch")
        except Exception as e:  # noqa: BLE001 — surface, don't hang
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]


def test_a_burst_of_connections_is_not_reset(served):
    """32 clients connect at the same instant and each sends one
    request: every one is answered.  (The reference's server listens
    with ThreadingHTTPServer's backlog of 5, and the kernel resets the
    connections a full accept queue cannot take; the port's listens with
    128.)"""
    _, port = served
    barrier = threading.Barrier(32)
    statuses, errors = [], []
    body = json.dumps({"instances": [[1, 2, 3, 4]]})

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            barrier.wait(timeout=30)
            conn.request("POST", "/v1/models/lin:predict", body=body)
            resp = conn.getresponse()
            resp.read()
            statuses.append(resp.status)
        except Exception as e:  # noqa: BLE001 - the failure under test
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert statuses == [200] * 32


def test_bf16_response_opt_in(served):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    _, port = served
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    status, raw, _ = _predict_binary(port, x)
    full = tc.unflatten_tree(*_frame_parts(raw))
    status, raw, _ = _predict_binary(
        port, x, meta={"response_wire": "bfloat16"})
    assert status == 200
    compressed = tc.unflatten_tree(*_frame_parts(raw))
    assert compressed.dtype == np.float32
    assert np.array_equal(
        compressed,
        full.astype(ml_dtypes.bfloat16).astype(np.float32))
    # An unknown wire dtype is a client error, not a silent full-
    # precision reply.
    status, raw, _ = _predict_binary(
        port, x, meta={"response_wire": "float8"})
    assert status == 400
    assert "response_wire" in json.loads(raw)["error"]


def _frame_parts(raw):
    frame = tc.decode_frame(raw)
    return frame.meta["tree"], frame.tensors


def test_binary_lookup_matches_json(served):
    _, port = served
    ids = [5, 1, 9, 5]
    status, raw, _ = _post(port, "/v1/models/lin:lookup",
                           json.dumps({"table": "users", "ids": ids}))
    assert status == 200
    jout = json.loads(raw)
    blob = tc.encode_frame({"ids": np.asarray(ids, np.int64)},
                           kind="lookup", meta={"table": "users"})
    status, raw, _ = _post(port, "/v1/models/lin:lookup", blob,
                           tc.FRAME_CONTENT_TYPE)
    assert status == 200
    frame = tc.decode_frame(raw)
    assert frame.meta["source"] == "export"
    assert np.array_equal(frame.tensors["vectors"],
                          np.asarray(jout["vectors"], np.float32))
    # Missing table meta is a 400, not a KeyError 500.
    blob = tc.encode_frame({"ids": np.asarray(ids, np.int64)},
                           kind="lookup")
    status, raw, _ = _post(port, "/v1/models/lin:lookup", blob,
                           tc.FRAME_CONTENT_TYPE)
    assert status == 400


def test_malformed_frames_refused_loudly(served):
    _, port = served
    for body in (b"", b"shrt", b"NOPE" + b"\x00" * 32,
                 tc.encode_frame({"x": np.zeros(4)})[:-3]):
        status, raw, _ = _post(port, "/v1/models/lin:predict", body,
                               tc.FRAME_CONTENT_TYPE)
        assert status == 400
        assert "bad frame" in json.loads(raw)["error"]
    # The server survives garbage: a good request still works.
    x = np.zeros((1, 4), np.float32)
    status, _, _ = _predict_binary(port, x)
    assert status == 200


def test_request_histogram_on_statz_and_metrics(served):
    endpoint, port = served
    _predict_binary(port, np.zeros((1, 4), np.float32))
    stats = endpoint.stats()
    hist = stats["hists"].get("serving.request")
    assert hist and hist["count"] >= 1
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", "/metrics")
    metrics = conn.getresponse().read().decode()
    conn.close()
    assert "elasticdl_serving_request_seconds_bucket" in metrics


# -- router pass-through invariants ---------------------------------------


class _CapturingReplica:
    """A fake model server that records exactly what the router sent
    and answers with a distinctive binary body."""

    def __init__(self):
        self.captured = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                body = json.dumps(
                    {"draining": False, "models": {}}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                outer.captured.append(
                    (self.path, self.headers.get("Content-Type"),
                     raw))
                body = b"\x01\x02frame-reply"
                self.send_response(200)
                self.send_header("Content-Type",
                                 tc.FRAME_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = "127.0.0.1:%d" % self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def routed():
    from elasticdl_tpu_torch.serving.router import (
        Router,
        build_router_server,
    )

    replicas = [_CapturingReplica(), _CapturingReplica()]
    router = Router([r.addr for r in replicas], probe_interval=0.1)
    router.start()
    server = build_router_server(router, port=0)
    threading.Thread(target=server.serve_forever,
                     daemon=True).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if len(router.state.routable(None)) == 2:
            break
        time.sleep(0.05)
    else:
        raise RuntimeError("replicas never became routable")
    yield router, server.server_address[1], replicas
    router.stop()
    server.shutdown()
    server.server_close()
    for r in replicas:
        r.close()


def test_router_forwards_binary_bodies_byte_identical(routed):
    router, port, replicas = routed
    from elasticdl_tpu_torch.serving.fleet import pick_replica

    blob = tc.encode_frame(
        {"instances": np.random.RandomState(0)
         .randn(16, 4).astype(np.float32)},
        kind="predict", routing_key="user-42")
    status, raw, ctype = _post(port, "/v1/models/lin:predict", blob,
                               tc.FRAME_CONTENT_TYPE)
    assert status == 200
    # Response bytes AND content type pass through untouched.
    assert raw == b"\x01\x02frame-reply"
    assert ctype == tc.FRAME_CONTENT_TYPE
    sent = [r for r in replicas if r.captured]
    assert len(sent) == 1
    path, fwd_type, fwd_raw = sent[0].captured[-1]
    # Byte-identical forward: zero re-encode, content type preserved.
    assert fwd_raw == blob
    assert fwd_type == tc.FRAME_CONTENT_TYPE
    # The frame header's routing key drove HRW placement: the chosen
    # replica is exactly the rendezvous pick for this key.
    expected = pick_replica("user-42",
                            sorted(r.addr for r in replicas))
    assert sent[0].addr == expected
    # Same key -> same replica, every time (header-only read is
    # deterministic).
    for _ in range(3):
        _post(port, "/v1/models/lin:predict", blob,
              tc.FRAME_CONTENT_TYPE)
    assert {r.addr for r in replicas if r.captured} == {expected}


def test_router_x_routing_key_skips_body_inspection(routed):
    _, port, replicas = routed
    # The body is NOT valid JSON and NOT a frame — with an explicit
    # header key the router must not even try to parse it.
    body = b"\x00\xffnot-json-not-frame"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/v1/models/lin:predict", body=body,
                     headers={"X-Routing-Key": "k7",
                              "Content-Type":
                                  "application/octet-stream"})
        resp = conn.getresponse()
        assert resp.status == 200
        resp.read()
    finally:
        conn.close()
    sent = [r for r in replicas if r.captured]
    assert sent and sent[0].captured[-1][2] == body
    assert sent[0].captured[-1][1] == "application/octet-stream"


def test_router_refuses_malformed_frame_without_forwarding(routed):
    _, port, replicas = routed
    before = sum(len(r.captured) for r in replicas)
    status, raw, _ = _post(port, "/v1/models/lin:predict",
                           b"EDXXgarbage-garbage-garbage",
                           tc.FRAME_CONTENT_TYPE)
    assert status == 400
    assert "bad frame" in json.loads(raw)["error"]
    assert sum(len(r.captured) for r in replicas) == before
    # A frame whose preamble LIES about its size must be refused from
    # the header read alone (never forwarded, never hangs).
    blob = bytearray(tc.encode_frame({"x": np.zeros(2, np.float32)},
                                     routing_key="k"))
    blob[8:16] = (99999).to_bytes(8, "little")  # payload_len lie
    status, raw, _ = _post(port, "/v1/models/lin:predict",
                           bytes(blob), tc.FRAME_CONTENT_TYPE)
    assert status == 400
    assert sum(len(r.captured) for r in replicas) == before


def test_router_binary_lookup_gets_table_affinity_key(routed):
    """A binary :lookup without an explicit routing key derives the
    SAME "table:<name>" affinity key the JSON path uses — one table's
    hot rows stay in ONE replica's cache regardless of content
    type."""
    from elasticdl_tpu_torch.serving.fleet import pick_replica

    blob = tc.encode_frame({"ids": np.arange(4, dtype=np.int64)},
                           kind="lookup", meta={"table": "users"})
    status, _, _ = _post(routed[1], "/v1/models/lin:lookup", blob,
                         tc.FRAME_CONTENT_TYPE)
    assert status == 200
    replicas = routed[2]
    sent = [r for r in replicas if r.captured]
    assert len(sent) == 1
    expected = pick_replica("table:users",
                            sorted(r.addr for r in replicas))
    assert sent[0].addr == expected
    # JSON lookups for the same table land on the SAME replica.
    status, _, _ = _post(routed[1], "/v1/models/lin:lookup",
                         json.dumps({"table": "users",
                                     "ids": [1, 2]}))
    assert status == 200
    assert {r.addr for r in replicas if r.captured} == {expected}


def test_router_over_port_replicas_forwards_binary_byte_identical(
        export_dir):
    """The router in front of two port replicas: a binary :predict and a
    binary :lookup through it answer byte for byte what the replica the
    key places them on answers directly."""
    from elasticdl_tpu_torch.serving.router import (
        Router,
        build_router_server,
    )

    endpoints, servers = [], []
    for _ in range(2):
        endpoints.append(ModelEndpoint(
            export_dir, device="cpu",
            batching=BatchConfig(max_batch_size=8, batch_timeout_ms=5.0,
                                 warm=False)))
        servers.append(build_server(endpoints[-1], port=0))
        threading.Thread(target=servers[-1].serve_forever,
                         daemon=True).start()
    addrs = ["127.0.0.1:%d" % s.server_address[1] for s in servers]
    router = Router(addrs, probe_interval=0.1)
    router.start()
    front = build_router_server(router, port=0)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    try:
        deadline = time.monotonic() + 10
        while len(router.state.routable(None)) != 2:
            assert time.monotonic() < deadline, "replicas never routable"
            time.sleep(0.05)
        x = np.random.RandomState(3).randint(-4, 5, (3, 4)).astype(
            np.float32)
        predict = tc.encode_frame({"instances": x}, kind="predict",
                                  routing_key="user-7")
        lookup = tc.encode_frame({"ids": np.asarray([9, 1, 5], np.int64)},
                                 kind="lookup", meta={"table": "users"})
        from elasticdl_tpu_torch.serving.fleet import pick_replica

        for path, blob, key in (
                ("/v1/models/lin:predict", predict, "user-7"),
                ("/v1/models/lin:lookup", lookup, "table:users")):
            status, via_router, ctype = _post(
                front.server_address[1], path, blob, tc.FRAME_CONTENT_TYPE)
            assert status == 200 and ctype == tc.FRAME_CONTENT_TYPE
            owner = pick_replica(key, sorted(addrs))
            status, direct, _ = _post(int(owner.rsplit(":", 1)[1]), path,
                                      blob, tc.FRAME_CONTENT_TYPE)
            assert status == 200
            assert via_router == direct
        frame = tc.decode_frame(via_router)
        assert frame.model_version == 3
        np.testing.assert_array_equal(frame.tensors["vectors"],
                                      [EMB[1][1], [0] * 4, EMB[1][0]])
    finally:
        router.stop()
        front.shutdown()
        front.server_close()
        for server, endpoint in zip(servers, endpoints):
            server.shutdown()
            server.server_close()
            endpoint.close()
