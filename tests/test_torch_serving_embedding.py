"""The port's twin of tests/test_serving_embedding.py: the PS-backed
shared embedding service (``elasticdl_tpu_torch/serving/
embedding_service.py``, a byte-identical copy of the reference's)
against the port's PS servicer and behind the port's ``ModelEndpoint``:
the byte-budgeted version-keyed hot-row LRU, read-only lookups that
never grow the training table, bit-identity with the exported-table
lookup path, generation-stamped invalidation after a PS restart, and the
/statz /metrics cache counters.  Exports are a test-only zoo entry
(``tests/torch_serving_zoo.py``), served on the CPU."""

import http.client
import json
import os
import threading

import numpy as np

from elasticdl_tpu_torch.proto import rpc
from elasticdl_tpu_torch.ps.optimizer import create_optimizer
from elasticdl_tpu_torch.ps.parameters import Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.serving import server as tserver
from elasticdl_tpu_torch.serving.embedding_service import (
    HotRowCache,
    PSEmbeddingService,
)
from elasticdl_tpu_torch.serving.server import build_server
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.ps_client import PSClient
from tests import torch_serving_zoo as zoo

DIM = 4


def ModelEndpoint(export_dir, **kwargs):
    return tserver.ModelEndpoint(export_dir, device="cpu", **kwargs)


def start_ps(num_ps=1, generation=1):
    servers, servicers, channels = [], [], []
    for i in range(num_ps):
        servicer = PserverServicer(
            Parameters(), create_optimizer("sgd", "learning_rate=0.1"),
            ps_id=i, num_ps=num_ps, generation=generation,
        )
        server = grpc_utils.build_server(max_workers=8)
        rpc.add_pserver_servicer(servicer, server)
        port = server.add_insecure_port("[::]:0")
        server.start()
        channel = grpc_utils.build_channel("localhost:%d" % port)
        grpc_utils.wait_for_channel_ready(channel)
        servers.append(server)
        servicers.append(servicer)
        channels.append(channel)
    return PSClient(channels), servicers, servers


def stop_all(servers):
    for s in servers:
        s.stop(grace=None)


def seed_table(client, n_rows, name="users"):
    """Create + initialize rows 0..n-1 the way training does (lazy
    init through a training-mode pull), returning the row matrix."""
    client.push_model({}, embedding_infos=[
        {"name": name, "dim": DIM, "initializer": "uniform"}])
    return client.pull_embedding_vectors(name, np.arange(n_rows))


# -- HotRowCache unit --------------------------------------------------


def test_cache_lru_eviction_is_byte_budgeted():
    timing = Timing()
    row_bytes = DIM * 4
    cache = HotRowCache(3 * row_bytes, timing=timing)
    key = (1, 0)
    rows = np.arange(5 * DIM, dtype=np.float32).reshape(5, DIM)
    cache.put_many(key, "t", [0, 1, 2], rows[:3])
    assert cache.stats()["bytes"] == 3 * row_bytes
    # Touch id 0 so id 1 is the LRU victim.
    got, missing = cache.get_many(key, "t", [0])
    assert missing == [] and np.array_equal(got[0], rows[0])
    cache.put_many(key, "t", [3], rows[3:4])
    stats = cache.stats()
    assert stats["bytes"] == 3 * row_bytes
    assert stats["evicted_rows"] == 1
    _, missing = cache.get_many(key, "t", [1])
    assert missing == [0]          # id 1 was evicted
    _, missing = cache.get_many(key, "t", [0, 2, 3])
    assert missing == []           # the survivors


def test_cache_version_key_invalidation_and_stale_put():
    cache = HotRowCache(1 << 20)
    rows = np.ones((2, DIM), np.float32)
    cache.put_many((1, 0), "t", [0, 1], rows)
    # Version flip (model hot-swap): wholesale drop, counted.
    got, missing = cache.get_many((2, 0), "t", [0, 1])
    assert missing == [0, 1]
    assert cache.stats()["invalidations"] == 1
    # Generation-epoch flip (PS restart) re-keys the same way.
    cache.put_many((2, 0), "t", [0], rows[:1])
    _, missing = cache.get_many((2, 1), "t", [0])
    assert missing == [0]
    assert cache.stats()["invalidations"] == 2
    # A put under a DEAD key (another thread re-keyed mid-pull)
    # inserts nothing.
    cache.put_many((1, 0), "t", [5], rows[:1])
    assert cache.stats()["rows"] == 0


def test_cache_disabled_at_zero_budget():
    cache = HotRowCache(0)
    cache.put_many((1, 0), "t", [0], np.ones((1, DIM), np.float32))
    _, missing = cache.get_many((1, 0), "t", [0])
    assert missing == [0]


# -- PS-backed service -------------------------------------------------


def test_ps_lookup_bit_identical_to_export_path(tmp_path):
    """The acceptance gate: a table served straight from the PS (never
    exported to disk) returns rows BIT-IDENTICAL to the exported-table
    lookup path, unknown ids included."""
    client, servicers, servers = start_ps()
    try:
        trained = seed_table(client, 8)
        # Export the SAME table into a servable (the old path)...
        export_dir = os.path.join(str(tmp_path), "e")
        zoo.export(
            export_dir, {"w": np.zeros((2, 2), np.float32)},
            np.zeros((1, 2), np.float32), model_name="m",
            embeddings={"users": (np.arange(8), trained)},
        )
        endpoint = ModelEndpoint(export_dir)
        # ...and serve it from the PS through the service (the new
        # path), cache on.
        service = PSEmbeddingService(client, cache_bytes=1 << 20)
        try:
            probe = np.array([3, 0, 7, 123456, 5, 3])
            via_export = endpoint.lookup(
                {"table": "users", "ids": probe.tolist()})
            via_ps = service.lookup("users", probe)
            np.testing.assert_array_equal(
                np.asarray(via_export["vectors"], np.float32), via_ps)
            # Second pass serves the hot ids from cache — still
            # bit-identical.
            np.testing.assert_array_equal(
                service.lookup("users", probe), via_ps)
            assert service.stats()["hits"] > 0
        finally:
            endpoint.close()
    finally:
        stop_all(servers)


def test_read_only_lookup_never_grows_the_table():
    client, servicers, servers = start_ps()
    try:
        seed_table(client, 4)
        table = servicers[0]._params.embeddings["users"]
        assert len(table) == 4
        service = PSEmbeddingService(client, cache_bytes=1 << 20)
        out = service.lookup("users", np.array([999999, 2]))
        assert (out[0] == 0).all()
        assert len(table) == 4          # no lazy init from serving
        assert servicers[0].counters["pull_embedding_ro"] >= 1
        # The training-mode pull still lazily initializes.
        client.pull_embedding_vectors("users", np.array([999999]))
        assert len(table) == 5
    finally:
        stop_all(servers)


def test_ps_restart_generation_invalidates_cache():
    """The lookup path rides PS generations (docs/ps_recovery.md): the
    read-only pull responses are generation-stamped, so an
    embedding-only client notices a crash-restore rollback and drops
    rows read from the dead incarnation."""
    client, servicers, servers = start_ps(generation=1)
    try:
        seed_table(client, 4)
        # probe_interval 0: every all-hit lookup still pays one probe
        # pull, so the restart is noticed immediately in the test (the
        # default cadence bounds the staleness window at ~2 s).
        service = PSEmbeddingService(client, cache_bytes=1 << 20,
                                     probe_interval_secs=0.0)
        service.set_version(1)
        service.lookup("users", np.arange(4))
        assert service.lookup("users", np.arange(4)) is not None
        stats = service.stats()
        assert stats["hits"] >= 4 and stats["rows"] == 4
        assert client.known_generation(0) == 1
        # "Restart" the shard: new incarnation, rolled-back rows.
        servicers[0].generation = 2
        servicers[0]._params.embeddings["users"].set(
            np.arange(4), np.zeros((4, DIM), np.float32))
        # The freshness probe's pull carries the new generation stamp;
        # the service re-keys MID-LOOKUP and re-pulls the whole batch,
        # so not even this first post-restart lookup mixes incarnations.
        out = service.lookup("users", np.arange(4))
        np.testing.assert_array_equal(out,
                                      np.zeros((4, DIM), np.float32))
        assert service.stats()["invalidations"] >= 1
        assert client.generation_epoch == 1
        counters = service.timing.counters()
        assert counters.get("emb_cache.freshness_probes", 0) >= 1
        assert counters.get("emb_cache.epoch_repulls", 0) == 1
    finally:
        stop_all(servers)


def test_set_version_invalidates_on_hot_swap():
    client, servicers, servers = start_ps()
    try:
        seed_table(client, 4)
        service = PSEmbeddingService(client, cache_bytes=1 << 20)
        service.set_version(1)
        service.lookup("users", np.arange(4))
        assert service.stats()["rows"] == 4
        service.set_version(2)      # fleet commit calls this
        service.lookup("users", np.arange(4))
        assert service.stats()["invalidations"] == 1
    finally:
        stop_all(servers)


def test_endpoint_routes_unexported_table_to_ps_and_statz(tmp_path):
    """:lookup for a table the export does not embed resolves through
    the PS service; the export's own tables keep the old path; the
    cache counters surface on /statz and /metrics."""
    client, servicers, servers = start_ps()
    try:
        trained = seed_table(client, 8, name="ps_only")
        export_dir = os.path.join(str(tmp_path), "e")
        zoo.export(
            export_dir, {"w": np.zeros((2, 2), np.float32)},
            np.zeros((1, 2), np.float32), model_name="m", version=5,
            embeddings={"local": (np.array([1, 2]),
                                  np.ones((2, 3), np.float32))},
        )
        service = PSEmbeddingService(client, cache_bytes=1 << 20)
        endpoint = ModelEndpoint(export_dir,
                                 embedding_service=service)
        server = build_server(endpoint, port=0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            conn.request("POST", "/v1/models/m:lookup",
                         body=json.dumps({"table": "ps_only",
                                          "ids": [0, 3, 7]}))
            res = json.loads(conn.getresponse().read())
            assert res["source"] == "ps"
            assert res["model_version"] == 5
            np.testing.assert_array_equal(
                np.asarray(res["vectors"], np.float32),
                trained[[0, 3, 7]])
            conn.request("POST", "/v1/models/m:lookup",
                         body=json.dumps({"table": "local",
                                          "ids": [1]}))
            res = json.loads(conn.getresponse().read())
            assert res["source"] == "export"
            assert res["vectors"] == [[1.0, 1.0, 1.0]]
            # The endpoint keyed the service at ITS serving version.
            assert service.stats()["version_key"][0] == 5
            conn.request("GET", "/statz")
            statz = json.loads(conn.getresponse().read())
            cache = statz["models"]["m"]["emb_cache"]
            assert cache["misses"] >= 3
            conn.request("GET", "/metrics")
            metrics = conn.getresponse().read().decode()
            assert "elasticdl_serving_emb_cache_bytes" in metrics
            assert "elasticdl_serving_emb_cache_hit_ratio" in metrics
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
            endpoint.close()
    finally:
        stop_all(servers)


def test_empty_ids_and_learned_dim():
    client, servicers, servers = start_ps()
    try:
        seed_table(client, 2)
        service = PSEmbeddingService(client, cache_bytes=1 << 20)
        out = service.lookup("users", np.array([], np.int64))
        assert out.shape == (0, DIM)
    finally:
        stop_all(servers)
