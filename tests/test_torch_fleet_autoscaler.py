"""The port's twin of tests/test_online_loop.py's autoscaler and
``drive_rollout`` cases: ``FleetAutoscaler`` over ``FleetState``
(``elasticdl_tpu_torch/serving/fleet.py``, byte-identical to the
reference's) against the reference tests' fake router and spawner, the
aggregator daemon's ``drive_rollout`` (``aggregation/main.py``) against
a fake fleet, and ``drive_rollout --canary_fraction`` end to end: two
port replica processes (``python -m elasticdl_tpu_torch.serving.server``
launched by ``ProcessReplicaSpawner``, on the CPU) behind the port's
router, version 2 taken through a canary slice, soaked under traffic and
promoted.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.aggregation.main import RouterClient, drive_rollout
from elasticdl_tpu_torch.serving.fleet import (
    FleetAutoscaler,
    FleetState,
    ProcessReplicaSpawner,
)
from elasticdl_tpu_torch.serving.router import Router, build_router_server
from tests import torch_serving_zoo as zoo

W = np.arange(8, dtype=np.float32).reshape(4, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the reference tests' fakes ----------------------------------------------


class _FakeRouter:
    def __init__(self, addrs, committed=1):
        self.state = FleetState(addrs, probe_interval=9999)
        self.committed = committed
        self.added = []
        self.removed = []

    def committed_view(self):
        return self.committed

    def add_replica(self, addr):
        self.state.add_replica(addr)
        self.added.append(addr)

    def remove_replica(self, addr):
        self.state.remove_replica(addr)
        self.removed.append(addr)

    def canary_addrs(self):
        return frozenset()


class _FakeSpawner:
    def __init__(self):
        self.spawned = []
        self.drained = []
        self.reaped = []

    def spawn(self, boot_version=None):
        addr = "spawned:%d" % len(self.spawned)
        self.spawned.append((addr, boot_version))
        return addr

    def drain(self, addr):
        self.drained.append(addr)

    def reap(self, addr, timeout=0):
        self.reaped.append(addr)


def _statz(queue_count, queue_sum_s, version=1, draining=False):
    return {
        "draining": draining,
        "models": {"m": {
            "version": version,
            "timing": {"batcher.queue_wait": {
                "count": queue_count,
                "mean_s": (queue_sum_s / queue_count)
                if queue_count else 0.0,
            }},
        }},
    }


def _feed(state, addr, count, total_s, now):
    state.note_probe_ok(addr, _statz(count, total_s), now)


def _scaler(router, spawner, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("scale_up_queue_ms", 25.0)
    kw.setdefault("scale_down_queue_ms", 2.0)
    kw.setdefault("breach_secs", 2.0)
    kw.setdefault("idle_secs", 5.0)
    kw.setdefault("cooldown_secs", 4.0)
    return FleetAutoscaler(router, spawner, **kw)


# -- the autoscaler ------------------------------------------------------------


def test_probe_differencing_yields_recent_queue_wait():
    state = FleetState(["a:1"], probe_interval=1)
    _feed(state, "a:1", 100, 10.0, now=0)   # lifetime mean 100ms
    _feed(state, "a:1", 150, 10.5, now=1)   # recent: 0.5s / 50 = 10ms
    row = state.replica_row("a:1")
    assert row["queue_wait_recent_ms"] == pytest.approx(10.0)
    _feed(state, "a:1", 150, 10.5, now=2)   # idle interval
    assert state.replica_row("a:1")[
        "queue_wait_recent_ms"] == pytest.approx(0.0)
    _feed(state, "a:1", 5, 0.1, now=3)      # counter reset (restart)
    assert state.replica_row("a:1")["queue_wait_recent_ms"] is None


def test_autoscaler_grows_on_sustained_breach_only():
    router = _FakeRouter(["a:1"], committed=7)
    spawner = _FakeSpawner()
    scaler = _scaler(router, spawner)
    _feed(router.state, "a:1", 10, 1.0, now=0)    # 100ms recent wait
    scaler.tick(now=0.0)
    scaler.tick(now=1.0)
    assert spawner.spawned == []                  # not sustained yet
    scaler.tick(now=2.5)
    assert [a for a, _ in spawner.spawned] == ["spawned:0"]
    # Spawn boots pinned to the committed version; admitted to table.
    assert spawner.spawned[0][1] == 7
    assert router.added == ["spawned:0"]
    # Cooldown: the breach persists but no second spawn yet.
    scaler.tick(now=3.0)
    assert len(spawner.spawned) == 1


def test_autoscaler_respects_max_replicas():
    router = _FakeRouter(["a:1", "b:2", "c:3"])
    spawner = _FakeSpawner()
    scaler = _scaler(router, spawner, max_replicas=3)
    for addr in ("a:1", "b:2", "c:3"):
        _feed(router.state, addr, 10, 5.0, now=0)
    scaler.tick(now=0.0)
    scaler.tick(now=10.0)
    assert spawner.spawned == []


def test_autoscaler_shrinks_idle_fleet_after_drain_completes():
    router = _FakeRouter(["a:1", "b:2"])
    spawner = _FakeSpawner()
    scaler = _scaler(router, spawner)
    for now in (0.0, 6.0):
        for addr in ("a:1", "b:2"):
            _feed(router.state, addr, 10, 0.0, now=now)
        scaler.tick(now=now)
    assert spawner.drained == ["a:1"]  # idle for >= idle_secs
    assert router.removed == []        # NOT removed until drained
    # A forward admitted BEFORE the drain flag landed is still live
    # when the replica starts reporting draining.
    assert router.state.acquire(None, members={"a:1"}) == "a:1"
    router.state.note_probe_ok("a:1", _statz(10, 0.0, draining=True),
                               7.0)
    scaler.tick(now=8.0)
    assert router.removed == []        # in-flight forward pending
    router.state.forward_finished("a:1")
    scaler.tick(now=9.0)
    assert router.removed == ["a:1"]
    assert spawner.reaped == ["a:1"]


def test_autoscaler_reaps_crashed_spawn_and_replaces_it():
    router = _FakeRouter(["a:1", "spawned:0"], committed=3)
    spawner = _FakeSpawner()
    # The spawner "owns" spawned:0 and reports its process exited.
    spawner.spawned.append(("spawned:0", 3))
    spawner.addrs = lambda: ["spawned:0"]
    spawner.poll = lambda addr: 1  # crashed
    scaler = _scaler(router, spawner, min_replicas=2)
    _feed(router.state, "a:1", 10, 0.05, now=0)
    scaler.tick(now=0.0)
    # The corpse left the table and the fleet dropped below min ->
    # replaced immediately.
    assert router.removed == ["spawned:0"]
    assert spawner.reaped == ["spawned:0"]
    assert [a for a, _ in spawner.spawned[1:]] == ["spawned:1"]
    # An operator-provided replica (not in spawner.addrs) is never
    # reaped, however dead it looks.
    assert "a:1" not in router.removed


def test_autoscaler_never_shrinks_an_operator_replica():
    """spawner.drain() is a no-op for a replica it does not own: only
    spawner-owned replicas are candidates."""
    router = _FakeRouter(["op:1", "spawned:0"])
    spawner = _FakeSpawner()
    spawner.spawned.append(("spawned:0", 1))
    spawner.addrs = lambda: ["spawned:0"]
    spawner.poll = lambda addr: None  # alive
    scaler = _scaler(router, spawner)
    for now in (0.0, 6.0):
        for addr in ("op:1", "spawned:0"):
            _feed(router.state, addr, 10, 0.0, now=now)
        scaler.tick(now=now)
    assert spawner.drained == ["spawned:0"]


def test_autoscaler_never_shrinks_below_min_or_drains_canary():
    router = _FakeRouter(["a:1", "b:2"])
    router.canary_addrs = lambda: frozenset(["a:1"])
    spawner = _FakeSpawner()
    scaler = _scaler(router, spawner, min_replicas=2)
    for now in (0.0, 6.0):
        for addr in ("a:1", "b:2"):
            _feed(router.state, addr, 10, 0.0, now=now)
        scaler.tick(now=now)
    assert spawner.drained == []  # min_replicas=2 floors the fleet
    scaler2 = _scaler(router, spawner, min_replicas=1)
    for now in (20.0, 26.0):
        scaler2.tick(now=now)
    # Only the non-canary replica is a shrink candidate.
    assert spawner.drained == ["b:2"]


# -- drive_rollout -------------------------------------------------------------


class _FakeFleet:
    """RouterClient-shaped stub for drive_rollout unit tests."""

    def __init__(self, canary_active=False, canary_requests=0):
        self.calls = []
        self.committed = 1
        self._active = canary_active
        self._requests = canary_requests

    def rollout(self, version, freshness=None):
        self.calls.append(("rollout", version))
        if self._active:
            return {"committed": False,
                    "error": "canary active (version 9); promote or "
                             "roll back first"}
        self.committed = version
        return {"committed": True, "committed_version": version}

    def canary_start(self, version, fraction, freshness=None):
        self.calls.append(("canary_start", version))
        if self._active:
            return {"started": False,
                    "error": "canary already active (version 9)"}
        return {"started": True}

    def canary_promote(self):
        self.calls.append(("promote",))
        self.committed = 9
        return {"promoted": True}

    def canary_rollback(self):
        self.calls.append(("rollback",))
        self._active = False
        return {"rolled_back": True}

    def status(self):
        return {"canary": {"cohorts": {"canary": {
            "requests": self._requests, "errors": 0}}}}

    def committed_version(self):
        return self.committed


def test_drive_rollout_recovers_from_stale_canary():
    fleet = _FakeFleet(canary_active=True)
    floor = drive_rollout(fleet, 12)
    assert ("rollback",) in fleet.calls
    assert fleet.calls.count(("rollout", 12)) == 2
    assert floor == 12
    fleet2 = _FakeFleet(canary_active=True)
    drive_rollout(fleet2, 12, canary_fraction=0.3, canary_soak_secs=0.01)
    assert ("rollback",) in fleet2.calls
    assert fleet2.committed == 12


def test_canary_with_no_soak_evidence_rolls_back():
    fleet = _FakeFleet(canary_requests=0)
    drive_rollout(fleet, 12, canary_fraction=0.3, canary_soak_secs=0.01)
    assert ("rollback",) in fleet.calls
    assert ("promote",) not in fleet.calls
    # A shutdown mid-soak must not promote an unvalidated version.
    stop = threading.Event()
    stop.set()
    fleet2 = _FakeFleet(canary_requests=50)
    drive_rollout(fleet2, 12, canary_fraction=0.3, canary_soak_secs=5.0,
                  stop_event=stop)
    assert ("promote",) not in fleet2.calls
    assert ("rollback",) in fleet2.calls


# -- drive_rollout --canary_fraction over replica processes ---------------------


def _export_version(base, version, bias=0.0):
    zoo.export(os.path.join(str(base), str(version)), {"w": W},
               np.zeros((1, 4), np.float32), bias=bias, model_name="lin",
               version=version)


def _predict(port, key):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/models/lin:predict", body=json.dumps(
            {"instances": [[1, 1, 1, 1]], "routing_key": key}))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _wait(predicate, timeout=60, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def test_drive_rollout_canary_over_replica_processes(tmp_path):
    """Two replica processes serve version 1 behind the router; the
    daemon's ``drive_rollout`` with ``canary_fraction`` 0.5 slices a
    canary for version 2, soaks it under traffic (its cohort answers with
    version 2's bias), and promotes it: the fleet commits version 2 and
    every answer after is version 2's.  No request fails throughout."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    spawner = ProcessReplicaSpawner(
        str(base), env=env,
        extra_args=["--max_batch_size", "4", "--batch_timeout_ms", "5"])
    addrs = [spawner.spawn(boot_version=1) for _ in range(2)]
    router = Router(addrs, export_dir=str(base), probe_interval=0.05,
                    poll_interval=0.1, auto_rollout=False)
    server = build_router_server(router, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    answers, stop = [], threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            answers.append(_predict(port, "user-%d" % (i % 64)))
            i += 1

    client = threading.Thread(target=traffic, daemon=True)
    try:
        router.start(coordinate=True)
        assert _wait(lambda: router.coordinator.committed_version == 1
                     and len(router.state.routable(1)) == 2), (
            router.fleet_status())
        client.start()
        _export_version(base, 2, bias=100.0)
        floor = drive_rollout(RouterClient("127.0.0.1:%d" % port), 2,
                              canary_fraction=0.5, canary_soak_secs=1.5)
        assert floor == 2 == router.coordinator.committed_version
        assert _wait(lambda: len(router.state.routable(2)) == 2)
        n = len(answers)
        assert _wait(lambda: len(answers) > n + 20)
    finally:
        stop.set()
        client.join(timeout=30)
        router.stop()
        server.shutdown()
        server.server_close()
        spawner.close()
    assert answers and all(status == 200 for status, _ in answers)
    by_version = {}
    for _, body in answers:
        by_version.setdefault(body["model_version"], set()).add(
            tuple(body["predictions"][0]))
    assert by_version[1] == {(12.0, 16.0)}
    assert by_version[2] == {(112.0, 116.0)}
    assert answers[-1][1]["model_version"] == 2
