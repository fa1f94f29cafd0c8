"""The port's aggregation tier (``elasticdl_tpu_torch/aggregation/``) and
``ContinuousExporter`` on the CPU: twins of tests/test_aggregation.py
and tests/test_ingest_stream.py.

``aggregation/main.py`` is the reference's module, copied
(tests/test_torch_copies.py); ``aggregator.py`` differs at the program
file (``model.pt2``, the port's ``torch.export`` program, for
``model.stablehlo``), so the reference's tests run here on port
exports: ingest monotonicity, the window math, atomic publish, the
freshness SLO, retention floors, program reuse (traced once across
versions of one tree, again on a tree change), the truthful reuse-path
manifest, the trainer's export cadence, the worker-0-only guard, the
frame carrier, streamed ingest with no filesystem, and the 422
re-prime after an aggregator restart.

The model is ``x @ w`` (a module holding one parameter named ``name``);
weights of one value make every output exact in float32.
"""

import json
import os

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.aggregation import ModelAggregator
from elasticdl_tpu_torch.aggregation.main import IngestServer
from elasticdl_tpu_torch.client.frame_client import (
    FrameClient,
    FrameClientError,
    ProgramRequiredError,
    StaleVersionError,
)
from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.serving.export import (
    PROGRAM_FILE,
    ContinuousExporter,
    ServingFunction,
    servable_from_frame,
)
from elasticdl_tpu_torch.serving.loader import list_versions
from elasticdl_tpu_torch.serving.loader import load_servable as _load
from elasticdl_tpu_torch.utils import tensor_codec
from elasticdl_tpu_torch.utils.tensor_codec import FrameError


class _Lin(torch.nn.Module):
    def __init__(self, name, n_out):
        super().__init__()
        self.name = name
        self.register_parameter(name, torch.nn.Parameter(
            torch.zeros(4, n_out)))

    def forward(self, x):
        return x @ getattr(self, self.name)


def _serve(name="w", n_out=2):
    spec = ModelSpec(
        name="lin", init_fn=None,
        apply_fn=lambda module, x, train: module(x), feed=None,
        params_from_jax=lambda named: dict(named),
        params_to_jax=None)
    return ServingFunction(spec, _Lin(name, n_out))


_APPLY = _serve()
X0 = np.zeros((1, 4), np.float32)


def load_servable(path):
    return _load(path, device="cpu")


def _exporter(base, **kw):
    return ContinuousExporter(str(base), model_name="lin", **kw)


def _export(ce, version, value):
    ce.export(version, _APPLY, {"w": np.full((4, 2), value, np.float32)},
              X0)


def _published_value(pub):
    out = load_servable(str(pub)).predict(np.ones((1, 4), np.float32))
    return float(out[0, 0]) / 4.0


def test_ingest_is_version_monotone(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    agg = ModelAggregator(str(src), str(pub), window=4)
    _export(ce, 10, 1.0)
    _export(ce, 20, 2.0)
    assert agg.ingest_once() == [10, 20]
    # A re-formed world's out-of-order export from a second exporter.
    _export(_exporter(src), 15, 9.0)
    assert agg.ingest_once() == []
    stats = agg.stats()
    assert stats["counters"]["stale_exports_skipped"] == 1
    assert stats["last_ingested_version"] == 20
    agg.ingest_once()
    assert agg.stats()["counters"]["stale_exports_skipped"] == 1


@pytest.mark.parametrize("mode,want", [
    ("mean", 2.0),
    ("ema", (0.25 * 1 + 0.5 * 2 + 1 * 3) / 1.75),
    ("latest", 3.0),
])
def test_mean_and_ema_window_math(tmp_path, mode, want):
    src = tmp_path / "src"
    ce = _exporter(src)
    for version, value in ((1, 1.0), (2, 2.0), (3, 3.0)):
        _export(ce, version, value)
    agg = ModelAggregator(str(src), str(tmp_path / mode), window=3,
                          mode=mode, ema_decay=0.5)
    agg.ingest_once()
    agg.publish()
    assert _published_value(tmp_path / mode) == pytest.approx(want)


def test_window_caps_membership(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    for version, value in ((1, 10.0), (2, 1.0), (3, 1.0)):
        _export(ce, version, value)
    agg = ModelAggregator(str(src), str(pub), window=2, mode="mean")
    agg.ingest_once()
    agg.publish()
    assert _published_value(pub) == pytest.approx(1.0)


def test_publish_is_atomic_and_carries_aggregation_manifest(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    _export(ce, 1, 1.0)
    _export(ce, 2, 2.0)
    agg = ModelAggregator(str(src), str(pub), window=2, mode="mean")
    agg.ingest_once()
    version, freshness = agg.publish()
    assert version == 2 and freshness >= 0.0
    assert sorted(os.listdir(pub)) == ["2"]
    assert sorted(os.listdir(pub / "2")) == ["manifest.json", "model.npz",
                                             PROGRAM_FILE]
    manifest = json.loads((pub / "2" / "manifest.json").read_text())
    assert manifest["version"] == 2
    assert manifest["aggregation"]["mode"] == "mean"
    assert manifest["aggregation"]["source_versions"] == [1, 2]
    assert manifest["format"] == "elasticdl_tpu_torch_servable_v1"
    assert manifest["program"] == PROGRAM_FILE
    # The published program is the source's, byte for byte.
    assert (pub / "2" / PROGRAM_FILE).read_bytes() == (
        src / "2" / PROGRAM_FILE).read_bytes()


def test_publish_due_throttle_and_slo_miss_counting(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    _export(ce, 1, 1.0)
    agg = ModelAggregator(str(src), str(pub), window=2,
                          freshness_slo_secs=0.0,
                          min_publish_interval_secs=3600.0)
    agg.ingest_once()
    assert agg.publish_due()
    agg.publish()
    assert agg.stats()["counters"]["slo_misses"] == 1
    _export(ce, 2, 2.0)
    agg.ingest_once()
    assert not agg.publish_due()
    assert agg.publish_due(now=agg._last_publish_at + 3601)


def test_retention_gc_floors_at_committed(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    agg = ModelAggregator(str(src), str(pub), window=1, export_keep=2)
    for version in (1, 2, 3, 4):
        _export(ce, version, float(version))
        agg.ingest_once()
        agg.publish()
    assert list_versions(str(pub)) == [1, 2, 3, 4]
    assert agg.gc_published(committed_floor=None) == []
    assert agg.gc_published(committed_floor=2) == [1]
    assert list_versions(str(pub)) == [2, 3, 4]
    assert agg.gc_published(committed_floor=4) == [2]
    assert list_versions(str(pub)) == [3, 4]


def test_broken_export_is_skipped_then_superseded(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    _export(ce, 1, 1.0)
    os.makedirs(src / "2")
    (src / "2" / "manifest.json").write_text("{}")
    agg = ModelAggregator(str(src), str(pub), window=4)
    assert agg.ingest_once() == [1]
    assert agg.stats()["counters"]["ingest_errors"] == 1
    _export(ce, 3, 3.0)
    assert agg.ingest_once() == [3]
    agg.ingest_once()
    assert agg.stats()["counters"]["stale_exports_skipped"] == 1


def test_continuous_exporter_reuses_program(tmp_path):
    src = tmp_path / "src"
    ce = _exporter(src)
    _export(ce, 1, 1.0)
    _export(ce, 2, 2.0)
    assert ce.traces == 1 and ce.exports == 2
    assert (src / "1" / PROGRAM_FILE).read_bytes() == (
        src / "2" / PROGRAM_FILE).read_bytes()
    out = load_servable(str(src / "2")).predict(np.ones((1, 4), np.float32))
    assert out[0, 0] == pytest.approx(8.0)
    # A changed parameter tree traces again instead of mis-serving.
    ce.export(3, _serve("w2", 3), {"w2": np.full((4, 3), 1.0, np.float32)},
              X0)
    assert ce.traces == 2
    assert load_servable(str(src / "3")).predict(
        np.ones((1, 4), np.float32)).shape == (1, 3)


def test_continuous_exporter_source_retention(tmp_path):
    src = tmp_path / "src"
    ce = _exporter(src, keep=3)
    for version in range(1, 7):
        _export(ce, version, float(version))
    assert list_versions(str(src)) == [4, 5, 6]
    unbounded = _exporter(tmp_path / "all", keep=0)
    for version in (1, 2):
        _export(unbounded, version, 1.0)
    assert list_versions(str(tmp_path / "all")) == [1, 2]


def test_continuous_exporter_reuse_path_manifest_is_truthful(tmp_path):
    src = tmp_path / "src"
    ce = _exporter(src, quantize="int8")
    table = (np.arange(256), np.ones((256, 16), np.float32))
    for version in (1, 2):  # 2 takes the reuse path
        ce.export(version, _APPLY, {"w": np.full((4, 2), 1.0, np.float32)},
                  X0, embeddings={"users": table})
    for version in (1, 2):
        manifest = json.loads(
            (src / str(version) / "manifest.json").read_text())
        with np.load(src / str(version) / "model.npz") as z:
            keys = set(z.files)
        assert manifest["format"].startswith("int8-emb+")
        assert "emb:users" in manifest["quantized_int8"]
        assert manifest["embedding_tables"] == ["users"]
        assert "q8emb/users" in keys and "emb_vals/users" not in keys
    model = load_servable(str(src / "2"))
    assert np.allclose(model.lookup_embedding("users", [3]), 1.0,
                       atol=0.02)


def test_trainer_export_hook_cadence(tmp_path):
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer,
    )

    src = tmp_path / "src"
    ce = ContinuousExporter(str(src), model_name="mnist")
    trainer = CollectiveTrainer(mnist.model_spec(learning_rate=1e-3),
                                batch_size=16, device="cpu", exporter=ce,
                                export_steps=3)
    xs, ys = mnist.synthetic_data(n=16)
    for step in range(1, 8):
        trainer.train_minibatch(xs, ys)
        if step == 6:
            at6 = trainer.predict_minibatch(xs[:2])
    assert trainer.steps_to_boundary() == 2  # next export at 9
    trainer.flush_checkpoints()  # joins the background export writes
    assert list_versions(str(src)) == [3, 6]
    assert ce.traces == 1
    model = load_servable(str(src))
    assert model.manifest["version"] == 6
    np.testing.assert_allclose(model.predict(xs[:2]), at6, atol=1e-5,
                               rtol=1e-5)
    assert trainer.timing.counters()["servable_exports"] == 2


def test_worker_main_guard_is_worker_zero_only(tmp_path):
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.utils.args import (
        check_ported,
        parse_worker_args,
    )
    from elasticdl_tpu_torch.worker.main import _build_collective_trainer

    spec = mnist.model_spec(learning_rate=1e-3)
    args = parse_worker_args([
        "--export_base", str(tmp_path / "src"), "--export_steps", "4",
        "--export_wire", "frame"])
    check_ported(args)  # the flags are ported
    chief = _build_collective_trainer(args, None, spec, 0, "cpu")
    follower = _build_collective_trainer(args, None, spec, 1, "cpu")
    assert chief._export_steps == 4
    assert chief._exporter.wire_format == "frame"
    assert follower._export_steps == 0 and follower._exporter is None


def test_republish_after_restart_is_an_idempotent_skip(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src)
    _export(ce, 5, 2.0)
    agg = ModelAggregator(str(src), str(pub), window=2, mode="mean")
    agg.ingest_once()
    agg.publish()
    before = (pub / "5" / "model.npz").read_bytes()
    agg2 = ModelAggregator(str(src), str(pub), window=2, mode="latest")
    agg2.ingest_once()
    version, _ = agg2.publish()
    assert version == 5
    assert agg2.stats()["counters"]["republish_skipped"] == 1
    assert (pub / "5" / "model.npz").read_bytes() == before
    manifest = _exporter(src).export(
        5, _APPLY, {"w": np.full((4, 2), 99.0, np.float32)}, X0)
    assert manifest["version"] == 5
    assert _published_value(src / "5") == pytest.approx(2.0)


def test_program_cache_keyed_on_shapes_not_names(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    agg = ModelAggregator(str(src), str(pub), window=1, mode="latest")
    _export(_exporter(src), 1, 1.0)
    agg.ingest_once()
    agg.publish()
    # Same flat name "w", a new shape (4, 3): a fresh exporter traces.
    _exporter(src).export(2, _serve("w", 3),
                          {"w": np.full((4, 3), 1.0, np.float32)}, X0)
    agg.ingest_once()
    agg.publish()
    out = load_servable(str(pub / "2")).predict(np.ones((1, 4), np.float32))
    assert out.shape == (1, 3)


def test_bad_mode_and_decay_refused(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        ModelAggregator(str(tmp_path), str(tmp_path), mode="median")
    with pytest.raises(ValueError, match="ema_decay"):
        ModelAggregator(str(tmp_path), str(tmp_path), ema_decay=1.5)


def test_frame_wire_source_ingests_and_publishes(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(src, wire_format="frame")
    for version, value in ((1, 1.0), (2, 3.0)):
        _export(ce, version, value)
    assert os.path.isfile(src / "1" / "model.frame")
    assert not os.path.exists(src / "1" / "model.npz")
    manifest = json.loads((src / "2" / "manifest.json").read_text())
    assert manifest["format"].startswith("frame+")
    with pytest.raises(ValueError, match="format"):
        load_servable(str(src / "2"))
    agg = ModelAggregator(str(src), str(pub), window=2, mode="mean")
    assert agg.ingest_once() == [1, 2]
    version, _ = agg.publish()
    assert version == 2
    assert _published_value(pub / "2") == pytest.approx(2.0)


def _frame(ce, version, value, **kw):
    return ce.frame_bytes(version, _APPLY,
                          {"w": np.full((4, 2), value, np.float32)}, X0,
                          **kw)


def test_streamed_frame_ingest_no_filesystem(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(tmp_path / "unused")
    agg = ModelAggregator(str(src), str(pub), window=2, mode="latest")
    first = _frame(ce, 1, 1.0)
    assert servable_from_frame(first)[3] is not None  # program rides
    steady = _frame(ce, 2, 2.0)
    assert servable_from_frame(steady)[3] is None     # weights only
    assert agg.ingest_frame(first) == 1
    assert agg.ingest_frame(steady) == 2
    assert agg.ingest_frame(first) is None            # stale: skipped
    stats = agg.stats()
    assert stats["counters"]["stale_exports_skipped"] == 1
    assert stats["counters"]["ingested_frames"] == 2
    version, _ = agg.publish()
    assert version == 2
    assert _published_value(pub / "2") == pytest.approx(2.0)
    assert not os.path.exists(tmp_path / "unused")


def test_streamed_tree_change_without_program_fails_loudly(tmp_path):
    src, pub = tmp_path / "src", tmp_path / "pub"
    ce = _exporter(tmp_path / "unused")
    agg = ModelAggregator(str(src), str(pub), window=1, mode="latest")
    agg.ingest_frame(_frame(ce, 1, 1.0))
    agg.publish()
    w2 = {"w2": np.full((4, 3), 1.0, np.float32)}
    agg.ingest_frame(ce.frame_bytes(2, _serve("w2", 3), w2, X0,
                                    include_program=False))
    with pytest.raises(RuntimeError, match="include_program"):
        agg.publish()
    agg2 = ModelAggregator(str(src), str(pub), window=1, mode="latest")
    agg2.ingest_frame(ce.frame_bytes(3, _serve("w2", 3), w2, X0,
                                     include_program=True))
    agg2.publish()
    assert load_servable(str(pub / "3")).predict(
        np.ones((1, 4), np.float32)).shape == (1, 3)


def test_exporter_wire_format_validation(tmp_path):
    with pytest.raises(ValueError, match="wire_format"):
        ContinuousExporter(str(tmp_path), wire_format="zip")


# -- streamed ingest over HTTP (twin of tests/test_ingest_stream.py) -------


@pytest.fixture
def rig(tmp_path):
    # Disjoint directories: everything arrives over the wire.
    agg = ModelAggregator(str(tmp_path / "agg_src"), str(tmp_path / "pub"),
                          window=2, mode="latest")
    server = IngestServer(agg, port=0, host="127.0.0.1")
    server.start()
    client = FrameClient("127.0.0.1:%d" % server.port, timeout=30)
    ce = _exporter(tmp_path / "trainer_side")
    try:
        yield agg, server, client, ce, tmp_path / "pub"
    finally:
        client.close()
        server.stop()


def test_ingest_roundtrip_and_status_contract(rig):
    agg, _, client, ce, pub = rig
    assert client.ingest(_frame(ce, 1, 1.0)) == 1
    assert client.ingest(_frame(ce, 2, 2.0)) == 2
    with pytest.raises(StaleVersionError) as err:
        client.ingest(_frame(ce, 1, 9.0))
    assert err.value.status == 409
    with pytest.raises(FrameError):
        client.ingest(b"\xff" * 64)
    status, _, _ = client.roundtrip("/ingest", b"{}",
                                    content_type="application/json")
    assert status == 415
    status, _, _ = client.roundtrip("/nope", b"")
    assert status == 404
    version, _ = agg.publish()
    assert version == 2
    out = load_servable(str(pub / "2")).predict(np.ones((1, 4), np.float32))
    assert out[0, 0] == pytest.approx(8.0)
    counters = agg.stats()["counters"]
    assert counters["ingested_frames"] == 2
    assert counters["stale_exports_skipped"] == 1
    assert counters["ingest_frame_rejected"] == 1


def test_hostile_blobs_then_keep_alive_survives(rig):
    _, _, client, ce, _ = rig
    good = _frame(ce, 1, 1.0)
    hostiles = [
        good[: len(good) - 7],
        b"NOPE" + good[4:],
        good[:4] + (2 ** 31).to_bytes(4, "little") + good[8:],
        tensor_codec.encode_frame({"x": np.zeros(1, np.float32)},
                                  kind="predict"),
    ]
    for blob in hostiles:
        with pytest.raises(FrameError):
            client.ingest(blob)
    assert client.ingest(good) == 1


def test_422_when_aggregator_lost_its_program_cache(rig):
    agg, _, client, ce, _ = rig
    assert client.ingest(_frame(ce, 1, 1.0)) == 1
    blob = ce.frame_bytes(2, _serve("w2", 3),
                          {"w2": np.full((4, 3), 1.0, np.float32)}, X0,
                          include_program=False)
    with pytest.raises(ProgramRequiredError) as err:
        client.ingest(blob)
    assert err.value.status == 422
    assert agg.stats()["counters"]["program_missing_rejected"] == 1
    assert agg.publish()[0] == 1


def test_stream_to_re_primes_after_aggregator_restart(rig, tmp_path):
    _, server, client, ce, _ = rig
    params = {"w": np.full((4, 2), 1.0, np.float32)}
    assert ce.stream_to(client, 1, _APPLY, params, X0) == 1
    assert ce.stream_to(client, 2, _APPLY, params, X0) == 2
    assert ce.stream_to(client, 1, _APPLY, params, X0) is None
    assert ce.stream_stats == {"pushed": 2, "stale": 1, "reprimed": 0}
    assert ce.traces == 1
    server.stop()
    agg2 = ModelAggregator(str(tmp_path / "agg2_src"),
                           str(tmp_path / "pub2"), window=2, mode="latest")
    server2 = IngestServer(agg2, port=0, host="127.0.0.1")
    server2.start()
    client2 = FrameClient("127.0.0.1:%d" % server2.port)
    try:
        assert ce.stream_to(client2, 3, _APPLY, params, X0) == 3
        assert ce.stream_stats["reprimed"] == 1
        assert ce.stream_stats["pushed"] == 3
        assert ce.traces == 1  # the re-prime reuses the traced program
        version, _ = agg2.publish()
        assert version == 3
        assert load_servable(str(tmp_path / "pub2" / "3")).predict(
            np.ones((1, 4), np.float32)).shape == (1, 2)
    finally:
        client2.close()
        server2.stop()


def test_cross_host_drill_freshness_slo_green(rig):
    agg, _, client, ce, _ = rig
    params = {"w": np.full((4, 2), 3.0, np.float32)}
    for v in (1, 2):
        assert ce.stream_to(client, v, _APPLY, params, X0) == v
    version, _ = agg.publish()
    assert version == 2
    stats = agg.stats()
    assert stats["freshness_seconds"] is not None
    assert stats["freshness_seconds"] < stats["freshness_slo_secs"]
    assert stats["counters"].get("ingested", 0) == 2
    assert stats["counters"]["ingested_frames"] == 2


def test_error_mapping_unknown_status():
    err = FrameClient._error(503, b'{"error": "draining"}')
    assert isinstance(err, FrameClientError)
    assert err.status == 503 and "draining" in err.message
    assert isinstance(FrameClient._error(400, b'{"error": "x"}'), FrameError)
    assert isinstance(FrameClient._error(409, b"{}"), StaleVersionError)
    assert isinstance(FrameClient._error(422, b"not json"),
                      ProgramRequiredError)
