"""The replicas' side of tests/test_online_loop.py on the port, and the
online-learning loop as a whole on the CPU.

Every test of the reference file that uses its ``fleet`` fixture runs
here on port replicas (``elasticdl_tpu_torch/serving/server.py``'s
``ModelEndpoint`` over program exports, behind the port's byte-identical
router): external rollouts with auto-rollout off, the regression refusal,
canary cohort isolation, promote, rollback, fallback evidence and input
validation; with the publish-only aggregation loop's retention and the
one-replica canary refusal.  The reference's policy-only tests (the
autoscaler, the seeding rule, the metrics renderer) exercise
``fleet.py`` alone, which the port holds byte-identical
(tests/test_torch_copies.py).

The loop as a whole:
 - the JAX and the port ``CollectiveTrainer`` start from the same mnist
   weights and take the same batches, each with its own
   ``ContinuousExporter`` (every 2 steps) and aggregator (mean over a
   window of 2); their published servables answer the same inputs
   within 5e-4 absolute and relative.  The two trainers' parameters
   drift apart by up to 1.4e-5 over three Adam steps
   (tests/test_torch_trainer.py), and a logit sums ~2,000 products of
   them;
 - a ``--distribution_strategy local`` job of the port with
   ``--export_base --export_steps --export_wire frame``, aggregated and
   served;
 - a zoo entry whose spec holds a ``ModelExporter`` callback: the
   master's train-end task makes a worker write a servable that loads.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.aggregation import ModelAggregator
from elasticdl_tpu_torch.aggregation.main import run_loop
from elasticdl_tpu_torch.serving.export import ContinuousExporter
from elasticdl_tpu_torch.serving.fleet import canary_slice
from elasticdl_tpu_torch.serving.loader import list_versions, load_servable
from elasticdl_tpu_torch.serving.router import Router, build_router_server
from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server
from elasticdl_tpu_torch.utils.prom import fleet_to_prometheus
from tests import torch_serving_zoo as zoo
from tests.test_torch_process_path import BANNED, REPO, Job

W = np.arange(8, dtype=np.float32).reshape(4, 2)


def _export_version(base, version, bias=0.0):
    zoo.export(os.path.join(str(base), str(version)), {"w": W},
               np.zeros((1, 4), np.float32), bias=bias, model_name="lin",
               version=version)


class _Replica:
    def __init__(self, base, **kwargs):
        kwargs.setdefault("fleet_managed", True)
        self.endpoint = ModelEndpoint(str(base), device="cpu", **kwargs)
        self.server = build_server(self.endpoint, port=0)
        self.addr = "127.0.0.1:%d" % self.server.server_address[1]
        self._dead = False
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def kill(self):
        """Close the listening socket: a dead replica process."""
        if not self._dead:
            self._dead = True
            self.server.shutdown()
            self.server.server_close()

    def close(self):
        self.kill()
        self.endpoint.close()


def _wait(predicate, timeout=20, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def fleet(tmp_path):
    """3 in-process port replicas behind an externally-driven router."""
    base = tmp_path / "exports"
    _export_version(base, 1)
    replicas = [_Replica(base) for _ in range(3)]
    router = Router([r.addr for r in replicas], export_dir=str(base),
                    probe_interval=0.05, poll_interval=0.1,
                    auto_rollout=False)
    server = build_router_server(router, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    router.start(coordinate=True)
    assert _wait(lambda: router.coordinator.committed_version == 1
                 and len(router.state.routable(1)) == 3), (
        router.fleet_status())
    yield {"router": router, "port": port, "base": base,
           "replicas": replicas}
    router.stop()
    server.shutdown()
    server.server_close()
    for replica in replicas:
        replica.close()


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(payload))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _predict(port, key):
    status, out = _post(port, "/v1/models/lin:predict",
                        {"instances": [[1, 1, 1, 1]],
                         "routing_key": key})
    return status, out.get("model_version")


def _keys(n=200):
    return ["user-%d" % i for i in range(n)]


# -- external rollout --------------------------------------------------


def test_external_rollout_and_auto_rollout_off(fleet):
    router, port, base = (fleet["router"], fleet["port"],
                          fleet["base"])
    _export_version(base, 2, bias=1.0)
    # auto_rollout=False: the scan loop must NOT pick it up itself.
    time.sleep(0.5)
    assert router.coordinator.committed_version == 1
    status, out = _post(port, "/fleet/rollout",
                        {"version": 2, "freshness_seconds": 1.5})
    assert status == 200 and out["committed"]
    assert out["committed_version"] == 2
    assert _wait(lambda: len(router.state.routable(2)) == 3)
    # Freshness telemetry landed on the fleet status + /metrics.
    assert fleet["router"].fleet_status()["aggregation"][
        "freshness_seconds"] == 1.5
    text = fleet_to_prometheus(router.fleet_status())
    assert "elasticdl_agg_freshness_seconds 1.5" in text
    assert "elasticdl_agg_published_version 2" in text


def test_rollout_refuses_regression_and_repeats_idempotently(fleet):
    port = fleet["port"]
    _, out = _post(port, "/fleet/rollout", {"version": 1})
    assert out["committed"]  # already there: idempotent success
    _, out = _post(port, "/fleet/rollout", {"version": 0})
    assert not out["committed"]
    assert "behind committed" in out["error"]


# -- canary ------------------------------------------------------------


def test_canary_cohort_isolation_then_barrier_clean_promote(fleet):
    router, port, base = (fleet["router"], fleet["port"],
                          fleet["base"])
    _export_version(base, 2, bias=1.0)
    status, out = _post(port, "/fleet/canary",
                        {"version": 2, "fraction": 0.3})
    assert status == 200 and out["started"], out
    assert len(out["replicas"]) == 1  # ceil(0.3 * 3)
    canary_keys = [k for k in _keys() if canary_slice(k) < 0.3]
    baseline_keys = [k for k in _keys() if canary_slice(k) >= 0.3]
    # The deterministic hash puts ~30% of keys on the canary slice.
    assert 0.2 < len(canary_keys) / len(_keys()) < 0.4
    for key in canary_keys[:8]:
        assert _predict(port, key) == (200, 2)
    for key in baseline_keys[:8]:
        assert _predict(port, key) == (200, 1)
    cohorts = router.cohort_stats()
    assert cohorts["canary"]["keyed_requests"] == 8
    assert cohorts["canary"]["model_version"] == 2
    assert cohorts["baseline"]["model_version"] == 1
    status, out = _post(port, "/fleet/canary/promote", {})
    assert out["promoted"] and out["committed_version"] == 2
    assert router.canary_view() is None
    assert _wait(lambda: len(router.state.routable(2)) == 3)
    # Post-promote: every key sees version 2 — and no key ever saw a
    # version regression (canary keys went 2 -> 2, baseline 1 -> 2).
    for key in canary_keys[:4] + baseline_keys[:4]:
        assert _predict(port, key) == (200, 2)


def test_canary_rollback_returns_replicas_to_committed(fleet):
    router, port, base = (fleet["router"], fleet["port"],
                          fleet["base"])
    _export_version(base, 2, bias=1.0)
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.34})
    assert out["started"]
    canary_addrs = set(out["replicas"])
    canary_key = next(k for k in _keys() if canary_slice(k) < 0.34)
    assert _predict(port, canary_key) == (200, 2)
    status, out = _post(port, "/fleet/canary/rollback", {})
    assert out["rolled_back"] and set(out["healed"]) == canary_addrs
    assert router.canary_view() is None
    assert router.coordinator.committed_version == 1
    # The rolled-back replicas serve the committed version again and
    # rejoin the one routable pool.
    assert _wait(lambda: len(router.state.routable(1)) == 3)
    assert _predict(port, canary_key) == (200, 1)


def test_canary_fallback_counts_as_baseline_evidence(fleet):
    """A dead canary pool must not mint canary evidence: fallback
    requests are served by baseline replicas at the committed version,
    so they count (and version-stamp) as baseline."""
    router, port, base = (fleet["router"], fleet["port"],
                          fleet["base"])
    _export_version(base, 2, bias=1.0)
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3})
    assert out["started"]
    # Kill the WHOLE canary pool mid-soak.
    for canary_addr in out["replicas"]:
        next(r for r in fleet["replicas"]
             if r.addr == canary_addr).kill()
    assert _wait(lambda: not any(
        router.state.replica_row(a)["healthy"]
        for a in out["replicas"]))
    before = router.cohort_stats()
    canary_key = next(k for k in _keys() if canary_slice(k) < 0.3)
    status, version = _predict(port, canary_key)
    assert (status, version) == (200, 1)  # served by baseline
    after = router.cohort_stats()
    assert after["canary"]["requests"] == before["canary"]["requests"]
    assert (after["baseline"]["requests"]
            == before["baseline"]["requests"] + 1)
    _, counters = router.state.snapshot()
    assert counters.get("router.canary_fallback", 0) >= 1
    _post(port, "/fleet/canary/rollback", {})


def test_canary_explicit_replica_list_is_validated(fleet):
    port, base = fleet["port"], fleet["base"]
    _export_version(base, 2, bias=1.0)
    addrs = [r.addr for r in fleet["replicas"]]
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3,
                    "replicas": ["127.0.0.1:1"]})
    assert not out["started"] and "not routable" in out["error"]
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3, "replicas": addrs})
    assert not out["started"] and "baseline" in out["error"]
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3,
                    "replicas": addrs[:1]})
    assert out["started"] and out["replicas"] == addrs[:1]
    _post(port, "/fleet/canary/rollback", {})


def test_publish_only_mode_still_runs_retention(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = ContinuousExporter(str(src), model_name="lin")
    w = np.full((4, 2), 1.0, np.float32)
    serve = zoo.serving_function()

    def export(version):
        ce.export(version, serve, {"w": w}, np.zeros((1, 4), np.float32))

    agg = ModelAggregator(str(src), str(pub), window=1,
                          mode="latest", export_keep=1)
    stop = threading.Event()
    runner = threading.Thread(
        target=run_loop, args=(agg, stop),
        kwargs={"router": None, "poll_interval": 0.05}, daemon=True)
    runner.start()
    # Staggered exports -> three separate publishes.
    for version in (1, 2, 3):
        export(version)
        assert _wait(lambda v=version: agg.stats()
                     ["last_published_version"] == v, 20)
    stop.set()
    runner.join(timeout=10)
    # keep=1 with the newest publish as the floor: 1 and 2 are GC'd.
    assert list_versions(str(pub)) == [3]


def test_canary_input_validation(fleet):
    router, port, base = (fleet["router"], fleet["port"],
                          fleet["base"])
    _export_version(base, 2, bias=1.0)
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 1.5})
    assert not out["started"] and "fraction" in out["error"]
    _, out = _post(port, "/fleet/canary",
                   {"version": 1, "fraction": 0.3})
    assert not out["started"] and "not ahead" in out["error"]
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3})
    assert out["started"]
    # One canary at a time; rollouts are refused while it runs.
    _, out = _post(port, "/fleet/canary",
                   {"version": 2, "fraction": 0.3})
    assert not out["started"] and "already active" in out["error"]
    _, out = _post(port, "/fleet/rollout", {"version": 2})
    assert not out["committed"] and "canary active" in out["error"]
    _post(port, "/fleet/canary/rollback", {})


def test_canary_needs_a_baseline_replica(tmp_path):
    base = tmp_path / "exports"
    _export_version(base, 1)
    replica = _Replica(base)
    router = Router([replica.addr], export_dir=str(base),
                    probe_interval=0.05, poll_interval=0.1,
                    auto_rollout=False)
    router.start(coordinate=True)
    try:
        assert _wait(
            lambda: len(router.state.routable(1)) == 1)
        _export_version(base, 2, bias=1.0)
        out = router.start_canary(2, 0.5)
        assert not out["started"]  # a 1-replica fleet can't slice
    finally:
        router.stop()
        replica.close()


# -- the loop as a whole ----------------------------------------------------


def test_jax_and_port_loops_publish_the_same_servable(tmp_path):
    """Each package trains, exports every 2 steps, aggregates (mean,
    window 2) and publishes; the two published servables agree."""
    from elasticdl_tpu.aggregation import ModelAggregator as JAggregator
    from elasticdl_tpu.models import mnist as jmnist
    from elasticdl_tpu.serving.export import (
        ContinuousExporter as JExporter,
    )
    from elasticdl_tpu.serving.loader import load_servable as jax_load
    from elasticdl_tpu.worker.collective_trainer import (
        CollectiveTrainer as JTrainer,
    )
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer,
    )
    from tests.test_torch_trainer import load_into_jax

    trainer = CollectiveTrainer(
        mnist.model_spec(learning_rate=1e-3), batch_size=16, device="cpu",
        rng_seed=1, exporter=ContinuousExporter(str(tmp_path / "src")),
        export_steps=2)
    jtrainer = JTrainer(
        jmnist.model_spec(learning_rate=1e-3), batch_size=16,
        exporter=JExporter(str(tmp_path / "jsrc"), platforms=("cpu",)),
        export_steps=2)
    load_into_jax(jtrainer, trainer.export_parameters())
    xs, ys = jmnist.synthetic_data(n=64, seed=3)
    for i in range(4):
        batch = (xs[16 * i:16 * i + 16], ys[16 * i:16 * i + 16])
        jtrainer.train_minibatch(*batch)
        trainer.train_minibatch(*batch)
    trainer.flush_checkpoints()
    jtrainer.flush_checkpoints()
    assert list_versions(str(tmp_path / "src")) == [2, 4]
    published = []
    for cls, src, pub in ((ModelAggregator, "src", "pub"),
                          (JAggregator, "jsrc", "jpub")):
        agg = cls(str(tmp_path / src), str(tmp_path / pub), window=2,
                  mode="mean")
        assert agg.ingest_once() == [2, 4]
        published.append(agg.publish()[0])
    assert published == [4, 4]
    x = xs[:5]
    got = load_servable(str(tmp_path / "pub"), device="cpu").predict(x)
    want = np.asarray(jax_load(str(tmp_path / "jpub")).predict(x))
    assert got.shape == want.shape == (5, 10)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def job_env(tmp_path_factory):
    """(cwd, env) for a port job on the CPU, the JAX packages shadowed
    by stand-ins that refuse to import (as test_torch_process_path)."""
    poison = tmp_path_factory.mktemp("banned")
    for name in BANNED:
        os.makedirs(poison / name)
        (poison / name / "__init__.py").write_text(
            "raise ImportError(%r)\n" % (
                "%s imported by a process of a port job" % name))
    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(poison), REPO])
    return str(tmp_path_factory.mktemp("cwd")), env


def test_local_job_exports_continuously(job_env, tmp_path):
    cwd, env = job_env
    src = tmp_path / "src"
    job = Job(["--model_zoo", "mnist", "--batch_size", "32",
               "--num_minibatches_per_task", "4",
               "--data_origin", "synthetic_mnist:256", "--num_workers", "1",
               "--export_base", str(src), "--export_steps", "4",
               "--export_wire", "frame"], cwd, env)
    assert job.finish(timeout=240) == 0, job.log
    assert "job finished" in job.log
    assert list_versions(str(src)) == [4, 8]
    assert os.path.isfile(src / "8" / "model.frame")
    agg = ModelAggregator(str(src), str(tmp_path / "pub"), window=2,
                          mode="latest")
    assert agg.ingest_once() == [4, 8]
    assert agg.publish()[0] == 8
    served = load_servable(str(tmp_path / "pub"), device="cpu")
    out = served.predict(np.zeros((3, 28, 28), np.float32))
    assert out.shape == (3, 10) and np.isfinite(out).all()


def test_train_end_callback_writes_a_servable(job_env, tmp_path):
    cwd, env = job_env
    export_dir = tmp_path / "export"
    job = Job(["--model_zoo", "tests.torch_export_zoo_callbacks",
               "--model_params", "export_dir=%s" % export_dir,
               "--batch_size", "32", "--num_minibatches_per_task", "4",
               "--data_origin", "synthetic_mnist:128", "--num_workers", "1"],
              cwd, env)
    assert job.finish(timeout=240) == 0, job.log
    assert list_versions(str(export_dir)) == [4]
    manifest = json.loads((export_dir / "4" / "manifest.json").read_text())
    assert manifest["program"] == "model.pt2"
    served = load_servable(str(export_dir), device="cpu")
    assert served.predict(np.zeros((2, 28, 28), np.float32)).shape == (2, 10)
