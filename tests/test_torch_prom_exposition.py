"""The port's Prometheus renderers (elasticdl_tpu_torch/utils/prom.py) and
metric registry (utils/metric_registry.py): the twin of
tests/test_prom_exposition.py, whose strict parser and status fixtures
this file reuses, plus byte equality with the JAX package's renderers.

For every renderer (master, multi-tenant master, serving replica, fleet
router, PS shard) the port's text for a status dict is byte for byte the
JAX renderer's text for the same dict; the port's histograms snapshot
as the JAX package's do, its registry is the JAX registry, and its
``jsonline`` copy reads the last JSON line as the JAX one does.
"""

import glob
import os
import re

import pytest

from elasticdl_tpu.utils import hist as jhist
from elasticdl_tpu.utils import metric_registry as jregistry
from elasticdl_tpu.utils import prom as jprom
from elasticdl_tpu.utils.jsonline import last_json_line as jlast_json_line
from elasticdl_tpu_torch.utils import hist, metric_registry, prom
from elasticdl_tpu_torch.utils.jsonline import last_json_line
from tests.test_prom_exposition import (
    _check_histograms,
    fleet_status,
    master_status,
    multitenant_status,
    parse_exposition,
    ps_status,
    serving_status,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RENDERERS = [
    ("master", "to_prometheus", master_status),
    ("multitenant", "multitenant_to_prometheus", multitenant_status),
    ("serving", "serving_to_prometheus", serving_status),
    ("fleet", "fleet_to_prometheus", fleet_status),
    ("ps", "ps_to_prometheus", ps_status),
]
IDS = [r[0] for r in RENDERERS]


def check_scrape(text):
    """tests/test_prom_exposition.check_scrape against the port's
    registry: grammar, duplicate series, histogram invariants."""
    samples = parse_exposition(text)
    seen = set()
    for name, labels, _ in samples:
        key = (name, tuple(sorted(labels.items())))
        assert key not in seen, "duplicate series %s%r" % (name, labels)
        seen.add(key)
    _check_histograms(samples)
    for name, _, _ in samples:
        assert metric_registry.is_declared(name), (
            "series %r not declared in the port's metric_registry" % name)
    return samples


@pytest.mark.parametrize("name,renderer,status", RENDERERS, ids=IDS)
def test_renderer_conforms(name, renderer, status):
    samples = check_scrape(getattr(prom, renderer)(status()))
    assert samples, "renderer %s emitted nothing" % name


@pytest.mark.parametrize("name,renderer,status", RENDERERS, ids=IDS)
def test_renderer_bytes_equal_the_jax_renderer(name, renderer, status):
    snapshot = status()
    got = getattr(prom, renderer)(snapshot)
    assert isinstance(got, str) and got.endswith("\n")
    assert got == getattr(jprom, renderer)(snapshot)


def test_histograms_snapshot_as_the_jax_package():
    values = [0.0004, 0.002, 0.002, 0.05, 0.4, 3.0, 120.0]
    ours, theirs = hist.Histogram(), jhist.Histogram()
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    assert hist.BUCKET_BOUNDS == jhist.BUCKET_BOUNDS
    assert ours.snapshot() == theirs.snapshot()
    lines, jlines = [], []
    prom.histogram_lines(lines, "elasticdl_job_step_time_seconds",
                         ours.snapshot(), job="a")
    jprom.histogram_lines(jlines, "elasticdl_job_step_time_seconds",
                          theirs.snapshot(), job="a")
    assert lines == jlines and lines


def test_histograms_render_on_every_latency_surface():
    expectations = [
        (prom.to_prometheus(master_status()),
         ["elasticdl_master_rpc_handle_seconds_bucket",
          "elasticdl_job_step_time_seconds_bucket"]),
        (prom.multitenant_to_prometheus(multitenant_status()),
         ["elasticdl_sched_decision_seconds_bucket",
          "elasticdl_job_step_time_seconds_bucket"]),
        (prom.serving_to_prometheus(serving_status()),
         ["elasticdl_serving_queue_wait_seconds_bucket",
          "elasticdl_serving_execute_seconds_bucket"]),
        (prom.fleet_to_prometheus(fleet_status()),
         ["elasticdl_fleet_replica_latency_seconds_bucket",
          "elasticdl_fleet_cohort_latency_seconds_bucket"]),
        (prom.ps_to_prometheus(ps_status()),
         ["elasticdl_ps_push_handle_seconds_bucket",
          "elasticdl_ps_pull_dense_seconds_bucket",
          "elasticdl_ps_pull_embedding_seconds_bucket"]),
    ]
    for text, names in expectations:
        for metric in names:
            assert metric + "{" in text or metric + " " in text, (
                "missing histogram %s" % metric)


def test_label_escaping_round_trips_hostile_job_name():
    samples = parse_exposition(
        prom.multitenant_to_prometheus(multitenant_status()))
    assert any(labels.get("job") == 'job-\\"b\\"\\n'
               for _, labels, _ in samples)
    assert prom.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


def test_registry_equals_the_jax_registry():
    assert metric_registry.METRICS == jregistry.METRICS
    for name, meta in metric_registry.METRICS.items():
        assert meta["help"].strip(), "registry entry %r has no help" % name
    assert metric_registry.is_declared("elasticdl_tasks_completed")
    assert not metric_registry.is_declared("elasticdl_no_such_series")


def test_docs_metric_tables_match_registry():
    tokens = set()
    for path in glob.glob(os.path.join(REPO, "docs", "*.md")):
        with open(path, encoding="utf-8") as f:
            tokens.update(re.findall(r"elasticdl_[a-z0-9_]+", f.read()))
    undeclared = sorted(
        t for t in tokens
        if not t.endswith("_")
        and not metric_registry.is_declared(t)
        and not t.startswith("elasticdl_tpu")  # the package names
    )
    assert not undeclared, undeclared


@pytest.mark.parametrize("text", [
    "", "no json here", 'log line\n{"a": 1}\nwarning\n',
    '{"a": 1}\n{"b": [2, 3]}\n', '{"a": 1}\n{broken\n', None])
def test_last_json_line_matches_the_jax_copy(text):
    assert last_json_line(text) == jlast_json_line(text)
