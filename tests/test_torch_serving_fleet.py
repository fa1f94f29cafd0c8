"""The port's twin of tests/test_serving_fleet.py: the fleet tier
(``elasticdl_tpu_torch/serving/{router, fleet}.py``, byte-identical
copies of the reference's) over port replicas, in process as the
reference test runs them: rendezvous-hash stability, retry-once failover
on an ejected replica, the no-mixed-version hot-swap barrier, graceful
SIGTERM drain, the rejoin-cannot-regress rule, and the Prometheus
/metrics surface; and a port replica process (``python -m
elasticdl_tpu_torch.serving.server``, launched by the fleet's
``ProcessReplicaSpawner``) drained by SIGTERM.

The model is the reference tests' exact ``x @ W + bias`` as a test-only
zoo entry (``tests/torch_serving_zoo.py``), on the CPU."""

import http.client
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.master.status_server import (
    fleet_to_prometheus,
    serving_to_prometheus,
)
from elasticdl_tpu_torch.serving import server as tserver
from elasticdl_tpu_torch.serving.batcher import BatchConfig
from elasticdl_tpu_torch.serving.fleet import (
    FleetCoordinator,
    FleetState,
    HealthProber,
    ProcessReplicaSpawner,
    _statz_view,
)
from elasticdl_tpu_torch.serving.router import (
    AdmissionGate,
    Router,
    build_router_server,
    pick_replica,
    rendezvous_rank,
)
from elasticdl_tpu_torch.serving.server import (
    DrainController,
    build_server,
    install_drain_handler,
)
from elasticdl_tpu_torch.utils.args import build_router_parser
from tests import torch_serving_zoo as zoo

W = np.arange(8, dtype=np.float32).reshape(4, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ModelEndpoint(export_dir, **kwargs):
    return tserver.ModelEndpoint(export_dir, device="cpu", **kwargs)


def _export_version(base, version, bias=0.0):
    zoo.export(
        os.path.join(str(base), str(version)), {"w": W},
        np.zeros((1, 4), np.float32), bias=bias, model_name="lin",
        version=version,
    )


class _Replica:
    """One in-process fleet-managed model server."""

    def __init__(self, base, **endpoint_kwargs):
        endpoint_kwargs.setdefault("fleet_managed", True)
        self.endpoint = ModelEndpoint(str(base), **endpoint_kwargs)
        self.server = build_server(self.endpoint, port=0)
        self.addr = "127.0.0.1:%d" % self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def kill(self):
        """Close the LISTENING socket so new connections are refused —
        the observable signature of a dead replica process."""
        self.server.shutdown()
        self.server.server_close()

    def close(self):
        self.kill()
        self.endpoint.close()


def _dead_addr():
    """A port that actively refuses connections."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return "127.0.0.1:%d" % port


def _post(port, path, payload, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload))
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw else None)
    finally:
        conn.close()


def _build_router(replica_addrs, base="", **kw):
    kw.setdefault("probe_interval", 0.05)
    kw.setdefault("probe_timeout", 2.0)
    kw.setdefault("poll_interval", 0.1)
    return Router(replica_addrs, export_dir=str(base), **kw)


def _wait(predicate, timeout=15, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# -- rendezvous hashing ------------------------------------------------


def test_rendezvous_removal_moves_only_the_lost_keyspace():
    """Removing a replica re-homes ONLY its own keys (each to its
    second choice); every other key keeps its replica."""
    addrs = ["r%d:80" % i for i in range(4)]
    keys = ["key-%d" % i for i in range(1000)]
    before = {k: pick_replica(k, addrs) for k in keys}
    removed = addrs[1]
    survivors = [a for a in addrs if a != removed]
    moved = 0
    for k in keys:
        after = pick_replica(k, survivors)
        if before[k] == removed:
            moved += 1
            # Failover lands on the key's SECOND rendezvous choice.
            assert after == rendezvous_rank(k, addrs)[1]
        else:
            assert after == before[k], k
    # ~1/N of the keyspace lived on the removed replica.
    assert 150 < moved < 350, moved


def test_rendezvous_addition_steals_about_one_nth():
    addrs = ["r%d:80" % i for i in range(4)]
    keys = ["key-%d" % i for i in range(1000)]
    before = {k: pick_replica(k, addrs) for k in keys}
    grown = addrs + ["r-new:80"]
    moved = sum(1 for k in keys if pick_replica(k, grown) != before[k])
    # Expected 1/5 = 200; generous bounds against hash variance.
    assert 120 < moved < 300, moved
    # Every moved key moved TO the new replica, never between old ones.
    for k in keys:
        after = pick_replica(k, grown)
        assert after == before[k] or after == "r-new:80"


def test_statz_view_takes_min_version_across_models():
    version, occupancy, wait_ms, recent_ms, draining = _statz_view({
        "draining": False,
        "models": {
            "a": {"version": 7, "mean_batch_occupancy": 3.0,
                  "queue_wait_recent_ms": 1.5,
                  "timing": {"batcher.queue_wait":
                             {"mean_s": 0.002, "count": 5}}},
            "b": {"version": 5, "mean_batch_occupancy": None,
                  "timing": {}},
        },
    })
    assert version == 5  # the barrier must hold for EVERY model
    assert occupancy == 3.0
    assert wait_ms == pytest.approx(2.0)
    assert recent_ms == pytest.approx(1.5)
    assert draining is False


# -- admission gate ----------------------------------------------------


def test_admission_gate_drains_before_reopening():
    gate = AdmissionGate()
    assert gate.enter(timeout=1)
    gate.close()
    # New entries are refused while closed...
    assert not gate.enter(timeout=0.05)
    # ...and the barrier waits for the in-flight one.
    assert not gate.wait_idle(timeout=0.05)
    gate.exit_()
    assert gate.wait_idle(timeout=1)
    gate.open()
    assert gate.enter(timeout=1)
    gate.exit_()


# -- routing + failover ------------------------------------------------


def test_router_routes_and_ejects_dead_replica_with_one_retry(
        tmp_path):
    """A replica that dies after passing its health probe: the next
    forward routed to it fails at the socket, the router ejects it and
    retries the request on a survivor EXACTLY once — the client sees
    one 200, never an error."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    alive = _Replica(base)
    doomed = _Replica(base)
    router = _build_router([alive.addr, doomed.addr], base)
    server = build_router_server(router, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        router.prober.probe_once()
        router.coordinator.tick()
        assert sorted(router.state.routable(1)) == sorted(
            [alive.addr, doomed.addr])
        # A key owned by the doomed replica, so the retry is exercised.
        key = next("k%d" % i for i in range(1000)
                   if pick_replica("k%d" % i,
                                   [alive.addr, doomed.addr])
                   == doomed.addr)
        doomed.kill()
        status, body = _post(port, "/v1/models/lin:predict",
                             {"instances": [[1, 2, 3, 4]],
                              "routing_key": key})
        assert status == 200, body
        assert body["model_version"] == 1
        replicas, counters = router.state.snapshot()
        assert counters.get("router.retried_requests") == 1
        assert replicas[doomed.addr]["healthy"] is False
        # Keyed traffic for the dead replica's keyspace now lands on
        # the survivor without any further retries.
        status, _ = _post(port, "/v1/models/lin:predict",
                          {"instances": [[1, 2, 3, 4]],
                           "routing_key": key})
        assert status == 200
        _, counters = router.state.snapshot()
        assert counters.get("router.retried_requests") == 1
    finally:
        server.shutdown()
        server.server_close()
        router.stop()
        alive.close()
        doomed.endpoint.close()


def test_routing_only_mode_serves_without_a_committed_version(
        tmp_path):
    """No --export_dir = routing-only: there is no committed version
    to pin to, so any healthy replica is routable (regression: the
    version filter used to demand serving_version == 0 and 503'd
    everything forever)."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    replica = _Replica(base)
    router = _build_router([replica.addr], "")
    server = build_router_server(router, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert not router.coordinating
        assert router.committed_view() is None
        router.prober.probe_once()
        status, body = _post(port, "/v1/models/lin:predict",
                             {"instances": [[1, 2, 3, 4]]})
        assert status == 200, body
        assert body["model_version"] == 1
        assert router.fleet_status()["coordinating"] is False
    finally:
        server.shutdown()
        server.server_close()
        router.stop()
        replica.close()


def test_ejected_replica_rides_back_in_with_backoff_probes(tmp_path):
    base = tmp_path / "exports"
    _export_version(base, 1)
    replica = _Replica(base)
    state = FleetState([replica.addr, _dead_addr()],
                       probe_interval=0.05)
    prober = HealthProber(state, probe_timeout=1.0)
    prober.probe_once()
    replicas, _ = state.snapshot()
    assert replicas[replica.addr]["healthy"] is True
    dead = next(a for a in replicas if a != replica.addr)
    assert replicas[dead]["healthy"] is False
    # The dead replica's next probe is pushed out by the jittered
    # backoff — strictly beyond the healthy cadence after a few misses.
    for _ in range(4):
        state.note_probe_failure(dead, time.monotonic())
    with state._lock:
        healthy_next = state._replicas[replica.addr].next_probe_at
        dead_next = state._replicas[dead].next_probe_at
    assert dead_next > healthy_next
    replica.close()


# -- fleet hot-swap ----------------------------------------------------


def test_version_flip_mid_storm_never_mixes_versions(tmp_path):
    """The acceptance drill in miniature: closed-loop keyed clients
    hammer the router while a new export version rolls out.  Every
    response is a 200, and no key EVER observes a version regression
    (new then old) — the barrier drains stale requests, it never mixes
    them."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    fleet = [_Replica(base) for _ in range(2)]
    router = _build_router([r.addr for r in fleet], base,
                           barrier_timeout=30.0)
    server = build_router_server(router, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    router.start(coordinate=True)
    try:
        assert _wait(lambda:
                     router.coordinator.committed_version == 1)
        errors = []
        observed = {}  # key -> [version, ...]
        stop = threading.Event()

        def client(idx):
            key = "storm-%d" % idx
            seen = observed.setdefault(key, [])
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            body = json.dumps({"instances": [[1, 2, 3, 4]],
                               "routing_key": key})
            try:
                while not stop.is_set():
                    conn.request("POST", "/v1/models/lin:predict",
                                 body=body)
                    resp = conn.getresponse()
                    raw = resp.read()
                    if resp.status != 200:
                        errors.append((resp.status, raw[:200]))
                        return
                    seen.append(json.loads(raw)["model_version"])
            except Exception as e:  # noqa: BLE001 — a dropped request
                # IS the failure this test exists to catch
                errors.append(repr(e))
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        # Fire the hot-swap mid-storm.
        time.sleep(0.3)
        _export_version(base, 2, bias=1.0)
        assert _wait(lambda:
                     router.coordinator.committed_version == 2)
        time.sleep(0.3)  # keep storming past the flip
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        flipped = 0
        for key, versions in observed.items():
            assert versions, key
            # Monotone non-decreasing: never v2 then v1 for one key.
            assert versions == sorted(versions), (key, versions)
            if versions[0] == 1 and versions[-1] == 2:
                flipped += 1
        assert flipped, observed  # the storm really straddled the flip
    finally:
        router.stop()
        server.shutdown()
        server.server_close()
        for r in fleet:
            r.close()


def test_rejoining_replica_heals_to_committed_never_regresses(
        tmp_path):
    """ISSUE satellite: loader polling and the version barrier must
    agree after a replica restarts mid-rollout.  The rejoiner booted
    while only version 1 was complete on its disk, so it serves 1; the
    fleet meanwhile committed 2.  It must NOT be routable at 1, its
    target must be seeded by the COORDINATOR (prepare+commit up to the
    committed version), and the replica-side commit_version must refuse
    any regression — so the fleet's committed version can never move
    backwards off a rejoiner's local disk scan."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    rejoiner = _Replica(base)          # boots while only v1 exists
    assert rejoiner.endpoint.serving_version() == 1
    _export_version(base, 2, bias=1.0)
    veteran = _Replica(base)           # boots after v2 landed
    assert veteran.endpoint.serving_version() == 2
    router = _build_router([veteran.addr, rejoiner.addr], base,
                           barrier_timeout=30.0)
    try:
        router.prober.probe_once()
        assert router.coordinator.seed_committed()
        # Committed adopts the fleet MAX (what the fleet last agreed
        # on), never the rejoiner's older disk state.
        assert router.coordinator.committed_version == 2
        # Not routable while lagging: the flip stays atomic per key.
        assert router.state.routable(2) == [veteran.addr]

        def healed():
            router.prober.probe_once()
            router.coordinator.tick()
            return rejoiner.endpoint.serving_version() == 2

        assert _wait(healed, timeout=30, interval=0.1)
        router.prober.probe_once()
        assert sorted(router.state.routable(2)) == sorted(
            [veteran.addr, rejoiner.addr])
        # Replica-side regression guard, independent of the router.
        refused = rejoiner.endpoint.commit_version(1)
        assert refused["committed"] is False
        assert "regress" in refused["error"]
        # Fleet-managed replicas never self-swap off a disk scan.
        rejoiner.endpoint.maybe_reload()
        assert rejoiner.endpoint.serving_version() == 2
    finally:
        router.stop()
        veteran.close()
        rejoiner.close()


# -- graceful drain ----------------------------------------------------


def test_sigterm_drains_then_stops(tmp_path):
    """SIGTERM mid-traffic: every in-flight/admitted request completes
    (200), later requests get 503 + Connection: close, the health
    probe fails so a router would eject the replica, and the server
    then stops on its own — no dropped connections at any point."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    endpoint = ModelEndpoint(
        str(base), batching=BatchConfig(max_batch_size=4,
                                        batch_timeout_ms=20.0,
                                        warm=False))
    server = build_server(endpoint, port=0)
    port = server.server_address[1]
    serve_thread = threading.Thread(target=server.serve_forever,
                                    daemon=True)
    serve_thread.start()
    old_handler = signal.getsignal(signal.SIGTERM)
    install_drain_handler(server, [endpoint], server.drain,
                          grace_secs=20.0)
    statuses = []
    lock = threading.Lock()

    def client():
        for _ in range(300):
            try:
                status, body = _post(
                    port, "/v1/models/lin:predict",
                    {"instances": [[1, 2, 3, 4]]}, timeout=30)
            except (ConnectionRefusedError, ConnectionResetError):
                # Clean post-shutdown refusal: the drained server
                # closed its listening socket (a connect racing the
                # close gets RST from the kernel backlog) — instantly
                # retryable against another replica, never a hung or
                # half-answered ADMITTED request (those are counted
                # in-flight and drained before the socket closes).
                with lock:
                    statuses.append("refused")
                return
            except OSError as e:
                with lock:
                    statuses.append(repr(e))
                return
            with lock:
                statuses.append(status)
            if status != 200:
                return

    try:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        os.kill(os.getpid(), signal.SIGTERM)
        for t in threads:
            t.join(timeout=30)
        # The server shuts itself down once drained.
        assert _wait(lambda: not serve_thread.is_alive(), timeout=20)
        with lock:
            seen = list(statuses)
        assert seen and set(seen) <= {200, 503, "refused"}, seen[:10]
        assert 200 in seen
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    # Refusal semantics directly on the controller.
    drain = DrainController()
    drain.begin()
    assert drain.admit() is False
    assert drain.wait_idle(0.1) is True


def test_drain_refusal_carries_connection_close(tmp_path):
    base = tmp_path / "exports"
    _export_version(base, 1)
    endpoint = ModelEndpoint(str(base))
    server = build_server(endpoint, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        server.drain.begin()
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=10)
        conn.request("POST", "/v1/models/lin:predict",
                     body=json.dumps({"instances": [[1, 2, 3, 4]]}))
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 503
        assert resp.getheader("Connection") == "close"
        conn.close()
        # The health probe fails too, so the router ejects us.
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=10)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 503
        conn.close()
        # /statz still answers (draining: true) for observability.
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=10)
        conn.request("GET", "/statz")
        resp = conn.getresponse()
        statz = json.loads(resp.read())
        assert statz["draining"] is True
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        endpoint.close()


def test_sigterm_drains_a_replica_process(tmp_path):
    """A port replica PROCESS (``python -m
    elasticdl_tpu_torch.serving.server --fleet_managed true``, launched
    by the fleet's spawner, asked for the CPU) answers until SIGTERM,
    then drains: clients see only 200s, then 503s or refused
    connections, and the process exits 0 within its grace."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    spawner = ProcessReplicaSpawner(
        str(base), env=env,
        extra_args=["--max_batch_size", "4", "--batch_timeout_ms", "5",
                    "--drain_grace_secs", "10"])
    addr = spawner.spawn()
    port = int(addr.rsplit(":", 1)[1])
    try:
        def up():
            try:
                return _post(port, "/v1/models/lin:predict",
                             {"instances": [[1, 2, 3, 4]]},
                             timeout=5)[0] == 200
            except OSError:
                return False

        assert _wait(up, timeout=60, interval=0.2), "replica never served"
        statuses = []
        lock = threading.Lock()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    status, body = _post(port, "/v1/models/lin:predict",
                                         {"instances": [[1, 2, 3, 4]]},
                                         timeout=30)
                except (ConnectionRefusedError, ConnectionResetError):
                    with lock:
                        statuses.append("refused")
                    return
                except OSError as e:
                    with lock:
                        statuses.append(repr(e))
                    return
                if status == 200 and body["predictions"] != [[40.0, 50.0]]:
                    status = "wrong answer %r" % (body,)
                with lock:
                    statuses.append(status)
                if status != 200:
                    return

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        spawner.drain(addr)
        assert _wait(lambda: spawner.poll(addr) is not None, timeout=15)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert spawner.poll(addr) == 0
        with lock:
            seen = list(statuses)
        assert seen and set(seen) <= {200, 503, "refused"}, seen[:10]
        assert 200 in seen
    finally:
        spawner.close()


# -- observability -----------------------------------------------------


def test_metrics_exposition_formats(tmp_path):
    base = tmp_path / "exports"
    _export_version(base, 3)
    endpoint = ModelEndpoint(str(base))
    server = build_server(endpoint, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, _ = _post(port, "/v1/models/lin:predict",
                          {"instances": [[1, 2, 3, 4]]})
        assert status == 200
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=10)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        assert resp.getheader("Content-Type").startswith("text/plain")
        conn.close()
        assert 'elasticdl_serving_version{model="lin"} 3' in body
        assert "elasticdl_serving_draining 0" in body
        # Router-side renderer over a synthetic fleet status.
        text = fleet_to_prometheus({
            "committed_version": 3,
            "replicas": {"a:1": {"healthy": True,
                                 "serving_version": 3,
                                 "inflight": 2,
                                 "queue_wait_ms": 1.5}},
            "counters": {"router.forwarded": 9},
        })
        assert "elasticdl_fleet_committed_version 3" in text
        assert ('elasticdl_fleet_replica_serving_version{replica='
                '"a:1"} 3') in text
        assert ('elasticdl_fleet_router_counter{name='
                '"router.forwarded"} 9') in text
        # Serving renderer includes the cache gauges when present.
        text = serving_to_prometheus({
            "draining": False,
            "models": {"lin": {
                "version": 3,
                "counters": {"batcher.requests": 4,
                             "batcher.batches": 2},
                "mean_batch_occupancy": 2.0,
                "timing": {"batcher.queue_wait":
                           {"mean_s": 0.001, "count": 4}},
                "emb_cache": {"bytes": 128, "rows": 2,
                              "evicted_rows": 1, "hits": 6,
                              "misses": 2, "hit_ratio": 0.75},
            }},
        })
        assert 'elasticdl_serving_occupancy{model="lin"} 2.0' in text
        assert ('elasticdl_serving_emb_cache_hit_ratio{model="lin"} '
                '0.75') in text
        assert ('elasticdl_serving_queue_wait_ms{model="lin"} 1.0'
                in text)
    finally:
        server.shutdown()
        server.server_close()
        endpoint.close()


def test_router_parser_roundtrip():
    args = build_router_parser().parse_args(
        ["--replicas", "a:1,b:2", "--export_dir", "/tmp/x",
         "--probe_interval", "0.25"])
    assert args.replicas == "a:1,b:2"
    assert args.probe_interval == 0.25
    assert args.barrier_timeout == 120.0
    with pytest.raises(SystemExit):
        build_router_parser().parse_args([])


def test_coordinator_seeds_from_replicas_not_disk(tmp_path):
    """The committed version adopts what the fleet actually serves (the
    max across healthy replicas), falling back to the export scan only
    when no replica has ever been probed."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    _export_version(base, 2)
    state = FleetState(["a:1"], probe_interval=0.05)
    coordinator = FleetCoordinator(state, str(base))
    state.note_probe_ok("a:1", {"models": {"lin": {"version": 1}}},
                        time.monotonic())
    assert coordinator.seed_committed()
    assert coordinator.committed_version == 1  # NOT the disk's 2
    # Unprobed fleet: disk scan fallback.
    coordinator2 = FleetCoordinator(
        FleetState(["b:1"], probe_interval=0.05), str(base))
    assert coordinator2.seed_committed()
    assert coordinator2.committed_version == 2
