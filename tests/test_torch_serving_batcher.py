"""The port's twin of tests/test_serving_batcher.py: dynamic request
batching (``elasticdl_tpu_torch/serving/batcher.py``, a byte-identical
copy of the reference's) behind the port's ``ModelEndpoint`` on the CPU:
coalescing, bucketed padding, hot-swap version discipline, timeout
flushes, :lookup through the admission queue, /statz counters, and the
batching-off path preserving one predict at a time.

The models are the reference tests' exact lambdas as a test-only zoo
entry (``tests/torch_serving_zoo.py``); the endpoint is asked for the
CPU, as nothing falls back to it on its own."""

import json
import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.serving import server as tserver
from elasticdl_tpu_torch.serving.batcher import (
    BatchConfig,
    batch_plan,
    default_buckets,
    pick_bucket,
)
from tests import torch_serving_zoo as zoo

W = np.arange(8, dtype=np.float32).reshape(4, 2)
build_server = tserver.build_server


def ModelEndpoint(export_dir, **kwargs):
    return tserver.ModelEndpoint(export_dir, device="cpu", **kwargs)


def _linear_export(path, model_name="lin"):
    zoo.export(
        path, {"w": W}, np.zeros((1, 4), np.float32),
        model_name=model_name,
        embeddings={"users": (np.array([5, 9]),
                              np.arange(8, dtype=np.float32)
                              .reshape(2, 4))},
    )


def _config(**kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_timeout_ms", 300.0)
    kw.setdefault("warm", False)
    return BatchConfig(**kw)


def test_default_buckets_and_pick():
    assert default_buckets(1) == [1]
    assert default_buckets(8) == [1, 2, 4, 8]
    assert default_buckets(12) == [1, 2, 4, 8, 12]
    assert pick_bucket(3, [1, 2, 4, 8]) == 4
    assert pick_bucket(8, [1, 2, 4, 8]) == 8
    with pytest.raises(ValueError):
        default_buckets(0)


def test_batch_config_validation():
    with pytest.raises(ValueError):
        BatchConfig(max_batch_size=0)
    with pytest.raises(ValueError):
        BatchConfig(batch_timeout_ms=-1)
    with pytest.raises(ValueError):
        BatchConfig(pad_buckets=[0, 4])
    # Explicit buckets that don't cover max_batch_size get it appended:
    # a full coalesced batch must always fit the top bucket.
    cfg = BatchConfig(max_batch_size=10, pad_buckets=[2, 4])
    assert cfg.pad_buckets == [2, 4, 10]
    assert not BatchConfig(max_batch_size=1).enabled
    assert BatchConfig(max_batch_size=2).enabled


def test_batch_plan_modes(tmp_path):
    _linear_export(tmp_path / "e")
    from elasticdl_tpu_torch.serving.loader import load_servable

    manifest = load_servable(str(tmp_path / "e"), device="cpu").manifest
    assert batch_plan(manifest) == {"mode": "array"}
    assert batch_plan(dict(manifest, polymorphic_batch=False)) is None
    # Dict model with a scalar aux leaf: only the free-lead leaves batch.
    plan = batch_plan({
        "polymorphic_batch": True,
        "input_signature": {
            "v": {"shape": [None, 4], "dtype": "float32"},
            "temp": {"shape": [], "dtype": "float32"},
        },
    })
    assert plan == {"mode": "dict", "batched": frozenset({"v"})}


def test_batched_responses_bit_identical_to_unbatched(tmp_path):
    """The acceptance bar: responses through the batcher (coalesced,
    padded, sliced) must equal the serialized-lock path bit for bit."""
    _linear_export(tmp_path / "e")
    plain = ModelEndpoint(str(tmp_path / "e"))
    batched = ModelEndpoint(str(tmp_path / "e"), batching=_config())
    try:
        bodies = [{"instances": [[k, k + 1, -k, 2.5 * k]
                                 for _ in range(1 + k % 3)]}
                  for k in range(8)]
        want = [plain.predict(b)["predictions"] for b in bodies]
        got = [None] * len(bodies)
        start = threading.Barrier(len(bodies))

        def hit(k):
            start.wait()
            got[k] = batched.predict(bodies[k])["predictions"]

        threads = [threading.Thread(target=hit, args=(k,))
                   for k in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for k in range(len(bodies)):
            assert got[k] is not None, k
            np.testing.assert_array_equal(got[k], want[k])
        counters = batched.timing.counters()
        # 8 concurrent requests against a 300 ms window must coalesce.
        assert counters["batcher.batches"] < counters["batcher.requests"]
    finally:
        plain.close()
        batched.close()


def test_padding_rows_never_leak(tmp_path):
    """A 3-row request pads to the 4-bucket; the response must carry
    exactly 3 rows with exact values — padded rows sliced away."""
    _linear_export(tmp_path / "e")
    endpoint = ModelEndpoint(
        str(tmp_path / "e"),
        batching=_config(batch_timeout_ms=5.0))
    try:
        x = [[1, 1, 1, 1], [0, 1, 0, 0], [2, 0, 0, 1]]
        out = endpoint.predict({"instances": x})["predictions"]
        assert len(out) == 3
        np.testing.assert_array_equal(
            out, (np.asarray(x, np.float32) @ W).tolist())
        counters = endpoint.timing.counters()
        assert counters["batcher.padded_rows"] >= 1
        assert counters["batcher.rows"] == 3
    finally:
        endpoint.close()


def test_pressure_aware_flush_and_timeout_bound(tmp_path):
    """An isolated request on an idle server flushes immediately — no
    batching latency tax at concurrency 1.  Under companion pressure
    the executor block-waits for the batch window, and a lone request
    then waits at most ~batch_timeout_ms before its batch flushes."""
    _linear_export(tmp_path / "e")
    endpoint = ModelEndpoint(
        str(tmp_path / "e"),
        batching=_config(batch_timeout_ms=150.0))
    try:
        endpoint.predict({"instances": [[0, 0, 0, 0]]})  # warm compile
        t0 = time.monotonic()
        endpoint.predict({"instances": [[1, 1, 1, 1]]})
        fast = time.monotonic() - t0
        assert fast < 0.1, "idle lone request paid the batch window"
        assert endpoint.timing.counters()[
            "batcher.empty_flushes"] >= 2
        # Flag companion pressure the way a concurrent burst would.
        endpoint._batcher._had_company = True
        t0 = time.monotonic()
        out = endpoint.predict({"instances": [[1, 1, 1, 1]]})
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(out["predictions"],
                                      [[12.0, 16.0]])
        assert elapsed >= 0.1, "pressured request skipped the window"
        assert elapsed < 2.0, "lone request stuck: %.2fs" % elapsed
        assert endpoint.timing.counters()[
            "batcher.timeout_flushes"] >= 1
    finally:
        endpoint.close()


def test_hot_swap_never_mixes_versions(tmp_path):
    """Hammer the batcher while new versions export: every response is
    internally consistent with exactly ONE exported version (a batch
    never mixes weights), and the latest version is eventually served
    — reloads take effect on the executor, between batches."""
    base = str(tmp_path / "m")
    scales = {v: float(v) for v in range(1, 5)}

    def put(version):
        zoo.export(
            os.path.join(base, str(version)),
            {"s": np.float32(scales[version])},
            np.zeros((1, 2), np.float32), kind="scale",
            model_name="hot", version=version)

    put(1)
    endpoint = ModelEndpoint(
        base, poll_interval=0.01,
        batching=_config(batch_timeout_ms=10.0))
    stop = threading.Event()
    failures, seen = [], set()

    def hammer():
        while not stop.is_set():
            try:
                out = endpoint.predict(
                    {"instances": [[1.0, 1.0]]})["predictions"]
                scale = out[0][0]
                if out != [[scale, scale]] or (
                        scale not in scales.values()):
                    failures.append(out)
                seen.add(scale)
            except Exception as e:  # noqa: BLE001
                failures.append(repr(e))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for version in range(2, 5):
            put(version)
            time.sleep(0.3)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and 4.0 not in seen:
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        endpoint.close()
    assert not failures, failures[:5]
    assert 4.0 in seen  # the last version took effect
    assert len(seen) >= 2  # at least one live flip observed


def test_aux_leaf_requests_do_not_coalesce(tmp_path):
    """Dict model with a scalar aux input: requests whose aux leaves
    differ must land in different batches (the aux value is shared by
    the whole executed batch), and both must come back correct."""
    zoo.export(
        tmp_path / "e", {"w": W},
        {"v": np.zeros((1, 4), np.float32), "temp": np.float32(1.0)},
        kind="aux", model_name="aux",
    )
    endpoint = ModelEndpoint(
        str(tmp_path / "e"),
        batching=_config(batch_timeout_ms=100.0))
    try:
        results = {}

        def hit(temp):
            results[temp] = endpoint.predict({
                "inputs": {"v": [[1, 1, 1, 1]], "temp": temp},
            })["predictions"]

        threads = [threading.Thread(target=hit, args=(temp,))
                   for temp in (2.0, 3.0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        np.testing.assert_array_equal(results[2.0], [[24.0, 32.0]])
        np.testing.assert_array_equal(results[3.0], [[36.0, 48.0]])
        counters = endpoint.timing.counters()
        assert counters["batcher.batches"] == 2  # never coalesced
    finally:
        endpoint.close()


def test_fixed_aux_output_not_sliced_on_bucket_collision(tmp_path):
    """An output leaf whose FIXED leading dim equals the pad bucket
    must still be shared whole, not sliced per request — the export's
    output_signature, not a shape coincidence, decides what batches."""
    aux = np.arange(8, dtype=np.float32).reshape(4, 2)
    zoo.export(
        tmp_path / "e", {"w": W, "c": aux},
        np.zeros((1, 4), np.float32), kind="auxout", model_name="auxout",
    )
    plain = ModelEndpoint(str(tmp_path / "e"))
    batched = ModelEndpoint(
        str(tmp_path / "e"),
        batching=_config(batch_timeout_ms=5.0))
    try:
        sig = plain.model.manifest["output_signature"]
        assert sig["y"]["shape"] == [None, 2]
        assert sig["aux"]["shape"] == [4, 2]
        # 3 rows pad to bucket 4 == aux's fixed leading dim.
        body = {"instances": [[1, 1, 1, 1], [0, 1, 0, 0], [2, 0, 0, 1]]}
        want = plain.predict(body)["predictions"]
        got = batched.predict(body)["predictions"]
        np.testing.assert_array_equal(got["aux"], aux.tolist())
        assert got == want
    finally:
        plain.close()
        batched.close()


def test_padded_rows_counted_once_for_multi_leaf_inputs(tmp_path):
    """Dict model with two batched leaves: padding is a per-BATCH
    statistic, not per-leaf (a 3-row request padded to bucket 4 counts
    1 padded row, not 2)."""
    zoo.export(
        tmp_path / "e", {"w": W},
        {"a": np.zeros((1, 4), np.float32),
         "b": np.zeros((1, 2), np.float32)},
        kind="two", model_name="two",
    )
    endpoint = ModelEndpoint(
        str(tmp_path / "e"),
        batching=_config(batch_timeout_ms=5.0))
    try:
        out = endpoint.predict({"inputs": {
            "a": [[1, 1, 1, 1]] * 3, "b": [[1, 2]] * 3,
        }})["predictions"]
        np.testing.assert_array_equal(out, [[13.0, 18.0]] * 3)
        assert endpoint.timing.counters()["batcher.padded_rows"] == 1
    finally:
        endpoint.close()


def test_unbatchable_model_rides_raw_path(tmp_path):
    """A fixed-shape export with batching enabled still serves: every
    predict runs on the executor (one execution point, swap-safe) but
    is never coalesced or padded."""
    zoo.export(
        tmp_path / "e", {"s": np.float32(2.0)},
        np.zeros((1, 4), np.float32), kind="scale",
        model_name="fixed", polymorphic_batch=False,
    )
    endpoint = ModelEndpoint(str(tmp_path / "e"), batching=_config())
    try:
        assert endpoint._snapshot()[2] is None  # no batch plan
        out = endpoint.predict({"instances": [[1, 2, 3, 4]]})
        np.testing.assert_array_equal(out["predictions"],
                                      [[2.0, 4.0, 6.0, 8.0]])
        counters = endpoint.timing.counters()
        assert counters["batcher.raw_requests"] == 1
        # Raw batches-of-one must not drag mean_batch_occupancy down.
        assert "batcher.batches" not in counters
    finally:
        endpoint.close()


def test_lookup_rides_the_admission_queue(tmp_path):
    """:lookup ships through the same queue (concatenated ids, split
    vectors): concurrent lookups stay correct and are counted apart
    from predict batches."""
    _linear_export(tmp_path / "e")
    endpoint = ModelEndpoint(str(tmp_path / "e"), batching=_config())
    try:
        results = {}

        def hit(k, ids):
            results[k] = endpoint.lookup(
                {"table": "users", "ids": ids})["vectors"]

        specs = {0: [9, 7], 1: [5], 2: [5, 9, 5]}
        threads = [threading.Thread(target=hit, args=(k, ids))
                   for k, ids in specs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        np.testing.assert_array_equal(
            results[0], [[4, 5, 6, 7], [0, 0, 0, 0]])
        np.testing.assert_array_equal(results[1], [[0, 1, 2, 3]])
        np.testing.assert_array_equal(
            results[2], [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3]])
        counters = endpoint.timing.counters()
        assert counters["batcher.lookup_rows"] == 6
        assert "batcher.batches" not in counters  # no predicts ran
        with pytest.raises(KeyError):
            endpoint.lookup({"table": "nope", "ids": [1]})
    finally:
        endpoint.close()


def test_statz_and_keepalive_over_http(tmp_path):
    """/statz surfaces the batching counters per model, and the server
    speaks HTTP/1.1 keep-alive: one connection serves many requests."""
    import http.client

    _linear_export(tmp_path / "e")
    endpoint = ModelEndpoint(
        str(tmp_path / "e"),
        batching=BatchConfig(max_batch_size=4, batch_timeout_ms=5.0,
                             warm=True))
    server = build_server(endpoint, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        for k in range(3):  # sequential requests, ONE connection
            conn.request(
                "POST", "/v1/models/lin:predict",
                body=json.dumps({"instances": [[k, 0, 0, 0]]}),
            )
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.headers.get("Connection", "") != "close"
            out = json.loads(resp.read())["predictions"]
            np.testing.assert_array_equal(out, [[0.0, 1.0 * k]])
        conn.request("GET", "/statz")
        statz = json.loads(conn.getresponse().read())
        assert statz["draining"] is False  # fleet drain flag rides
        # /statz so the router's health probe keys off one payload
        stats = statz["models"]["lin"]
        assert stats["batching"]["max_batch_size"] == 4
        assert stats["batching"]["pad_buckets"] == [1, 2, 4]
        assert stats["counters"]["batcher.requests"] == 3
        assert stats["counters"]["batcher.rows"] == 3
        assert stats["counters"]["batcher.warmed_models"] == 1
        assert stats["mean_batch_occupancy"] == 1.0
        assert "batcher.queue_wait" in stats["timing"]
        assert "batcher.execute" in stats["timing"]
        # Keep-alive framing depends on Content-Length: a chunked body
        # must get 411 + close, not desync the persistent connection.
        import socket

        raw = socket.create_connection(("127.0.0.1", port),
                                       timeout=30)
        try:
            raw.sendall(b"POST /v1/models/lin:predict HTTP/1.1\r\n"
                        b"Host: t\r\nTransfer-Encoding: chunked\r\n"
                        b"\r\n")
            status = raw.recv(65536).split(b"\r\n", 1)[0]
            assert b"411" in status, status
        finally:
            raw.close()
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        endpoint.close()


def test_batching_off_preserves_serialized_path(tmp_path):
    """No batching config (or a disabled one): no executor thread, no
    queue — predict/lookup take the original execution-lock path, and
    /statz still answers with batching: null."""
    _linear_export(tmp_path / "e")
    plain = ModelEndpoint(str(tmp_path / "e"))
    disabled = ModelEndpoint(str(tmp_path / "e"),
                             batching=BatchConfig(max_batch_size=1))
    try:
        for endpoint in (plain, disabled):
            assert endpoint._batcher is None
            out = endpoint.predict({"instances": [[1, 1, 1, 1]]})
            np.testing.assert_array_equal(out["predictions"],
                                          [[12.0, 16.0]])
            assert endpoint.stats()["batching"] is None
            assert "batcher.batches" not in endpoint.timing.counters()
            endpoint.close()  # no-op without a batcher
    finally:
        plain.close()
        disabled.close()


def test_batch_config_from_cli_args():
    from elasticdl_tpu_torch.serving.server import batch_config_from_args
    from elasticdl_tpu_torch.utils.args import build_serving_parser

    parser = build_serving_parser()
    args = parser.parse_args(["--export_dir", "/x"])
    cfg = batch_config_from_args(args)
    assert cfg is not None and cfg.max_batch_size == 32
    assert cfg.pad_buckets == [1, 2, 4, 8, 16, 32]

    args = parser.parse_args(
        ["--export_dir", "/x", "--max_batch_size", "1"])
    assert batch_config_from_args(args) is None
    args = parser.parse_args(
        ["--export_dir", "/x", "--enable_batching", "false"])
    assert batch_config_from_args(args) is None
    args = parser.parse_args(
        ["--export_dir", "/x", "--max_batch_size", "16",
         "--pad_buckets", "4,16", "--batch_timeout_ms", "7.5",
         "--warm_buckets", "false"])
    cfg = batch_config_from_args(args)
    assert cfg.pad_buckets == [4, 16]
    assert cfg.batch_timeout_ms == 7.5
    assert cfg.warm is False
