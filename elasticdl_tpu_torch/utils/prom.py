"""Prometheus text-exposition rendering — the ONE implementation.

Every /metrics endpoint in the system (master status server, PS shard,
serving replicas, fleet router) renders through ``prometheus_line``,
so label escaping exists exactly once and a real scraper reads one
format across the control plane, the PS tier, and the serving tier.
Before this module the renderers lived in master/status_server.py
(which still re-exports them for compatibility); the serving tier now
imports from here and no longer depends on the master package.

Escaping per the exposition format spec: label values escape
backslash, double-quote, and newline.  Metric names and label names
are caller-controlled identifiers and are NOT escaped — a bad name is
a bug, not data.

Latency series render as NATIVE Prometheus histograms
(``histogram_lines``: ``_bucket{le=}``/``_sum``/``_count`` over the
fixed utils/hist.py boundary set), so a standard scraper derives p99
with ``histogram_quantile()`` on every surface — no lifetime means.

Every ``elasticdl_*`` series name emitted here (or anywhere) must be
declared in ``utils/metric_registry.py`` — elastic-lint EL010 fails
on a typo'd or undocumented series.
"""

from elasticdl_tpu_torch.utils.hist import BUCKET_BOUNDS


def escape_label_value(value):
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def prometheus_line(metric, value, **labels):
    """One exposition-format sample line."""
    label_str = ""
    if labels:
        label_str = "{%s}" % ",".join(
            '%s="%s"' % (name, escape_label_value(val))
            for name, val in sorted(labels.items())
        )
    return "%s%s %s" % (metric, label_str, value)


def _format_bound(bound):
    """Shortest exact-ish decimal for a ``le`` label value."""
    return "%.10g" % bound


def histogram_lines(lines, metric, snap, **labels):
    """Render one utils/hist.py snapshot as a native Prometheus
    histogram: cumulative ``<metric>_bucket{le=...}`` rows over the
    shared boundary set, the mandatory ``le="+Inf"`` row equal to
    ``<metric>_count``, plus ``<metric>_sum``.  Values are SECONDS
    (the Prometheus base-unit convention) — callers converting from
    ms scale before snapshotting, not here."""
    if not snap:
        return
    cumulative = 0
    for bound, count in zip(BUCKET_BOUNDS, snap["counts"]):
        cumulative += count
        lines.append(prometheus_line(
            "%s_bucket" % metric, cumulative,
            le=_format_bound(bound), **labels))
    lines.append(prometheus_line(
        "%s_bucket" % metric, snap["count"], le="+Inf", **labels))
    lines.append(prometheus_line(
        "%s_sum" % metric, "%.9g" % snap["sum"], **labels))
    lines.append(prometheus_line(
        "%s_count" % metric, snap["count"], **labels))


def _slo_gauges(lines, slo):
    """The SLO watchdog's /metrics rows (utils/slo.py payload shape):
    per-rule ok gauge + breach-episode counter — shared by every
    renderer so alerting reads one format across tiers."""
    for rule, r in sorted((slo or {}).get("rules", {}).items()):
        labels = {"rule": rule}
        lines.append(prometheus_line(
            "elasticdl_slo_ok", int(bool(r.get("ok", True))), **labels))
        lines.append(prometheus_line(
            "elasticdl_slo_breach_total", r.get("breach_total", 0),
            **labels))


def _task_gauges(lines, tasks, finished, **labels):
    """The per-job task-count gauge block — ONE implementation shared
    by the single-job renderer (no labels) and the multi-tenant one
    (job=<name>), so the two can never drift."""
    lines.append(prometheus_line("elasticdl_tasks_todo",
                                 tasks["todo"], **labels))
    lines.append(prometheus_line("elasticdl_tasks_doing",
                                 tasks["doing"], **labels))
    lines.append(prometheus_line("elasticdl_data_epoch",
                                 tasks["epoch"], **labels))
    for kind in ("completed", "failed"):
        for task_type, count in tasks[kind].items():
            lines.append(prometheus_line(
                "elasticdl_tasks_%s" % kind, count,
                type=str(task_type), **labels))
    lines.append(prometheus_line("elasticdl_job_finished",
                                 int(finished), **labels))


def _telemetry_gauges(lines, telemetry, **labels):
    """Per-job aggregate + per-worker training-health gauges
    (docs/observability.md) — the resize-controller sensor surface,
    shared by both master renderers."""
    if not telemetry:
        return
    job = telemetry.get("job", {})
    if job.get("steps_per_sec") is not None:
        lines.append(prometheus_line(
            "elasticdl_job_steps_per_sec",
            round(job["steps_per_sec"], 3), **labels))
    lines.append(prometheus_line(
        "elasticdl_telemetry_workers_reporting",
        job.get("workers_reporting", 0), **labels))
    for worker_id, t in sorted(telemetry.get("workers", {}).items()):
        if not t.get("fresh", True):
            # Stale workers stay in the /status JSON (with their
            # age) but leave /metrics: a scraper reading per-worker
            # gauges must never sum an hours-dead worker's last
            # steps/s into "live" throughput.
            continue
        wl = dict(labels, worker=str(worker_id))
        lines.append(prometheus_line(
            "elasticdl_worker_steps_per_sec",
            round(t.get("steps_per_sec", 0.0), 3), **wl))
        if t.get("sync_fraction") is not None:
            lines.append(prometheus_line(
                "elasticdl_worker_sync_fraction",
                round(t["sync_fraction"], 4), **wl))
        if t.get("push_staleness") is not None:
            lines.append(prometheus_line(
                "elasticdl_worker_push_staleness",
                round(t["push_staleness"], 3), **wl))
        if t.get("window_size") is not None:
            lines.append(prometheus_line(
                "elasticdl_worker_window_size",
                round(t["window_size"], 3), **wl))
        lines.append(prometheus_line(
            "elasticdl_worker_steps_done",
            t.get("steps_done", 0), **wl))
        # Straggler plane (docs/observability.md): the sustained
        # cross-worker skew flag plus the recent per-worker p50 the
        # detector judged on.
        if t.get("straggler") is not None:
            lines.append(prometheus_line(
                "elasticdl_worker_straggler",
                int(bool(t["straggler"])), **wl))
        if t.get("step_p50_ms") is not None:
            lines.append(prometheus_line(
                "elasticdl_worker_step_p50_seconds",
                round(t["step_p50_ms"] / 1e3, 6), **wl))
    if job.get("step_hist"):
        # TRUE per-job step-time distribution: exact merge of the
        # per-worker histogram deltas piggybacked on progress RPCs —
        # a scraper's histogram_quantile() here is a real p99, not a
        # mean of worker means.
        histogram_lines(lines, "elasticdl_job_step_time_seconds",
                        job["step_hist"], **labels)


def to_prometheus(status):
    """Master /metrics renderer over ``collect_status``'s dict."""
    lines = []

    def gauge(metric, value, **labels):
        lines.append(prometheus_line(metric, value, **labels))

    _task_gauges(lines, status["tasks"], status["finished"])
    if "workers" in status:
        gauge("elasticdl_workers_live", len(status["workers"]["live"]))
    if "rendezvous" in status:
        gauge("elasticdl_rendezvous_epoch",
              status["rendezvous"]["epoch"])
        gauge("elasticdl_rendezvous_world_size",
              len(status["rendezvous"]["world"]))
    for name, value in status.get("exec_counters", {}).items():
        gauge("elasticdl_worker_counter", value, name=name)
    if "ps" in status:
        gauge("elasticdl_ps_commit_mark", status["ps"]["commit_mark"])
        for ps_id, shard in sorted(status["ps"]["shards"].items()):
            gauge("elasticdl_ps_shard_generation",
                  shard["generation"], ps_id=str(ps_id))
            gauge("elasticdl_ps_shard_durable_version",
                  shard["durable_version"], ps_id=str(ps_id))
    _telemetry_gauges(lines, status.get("telemetry"))
    for method, snap in sorted(status.get("rpc_hists", {}).items()):
        histogram_lines(lines, "elasticdl_master_rpc_handle_seconds",
                        snap, method=method)
    _slo_gauges(lines, status.get("slo"))
    return "\n".join(lines) + "\n"


def multitenant_to_prometheus(status):
    """Multi-tenant master /metrics renderer over
    ``collect_multitenant_status``'s dict (docs/scheduler.md): the
    scheduler plane (pool size, admission queue depth, decision
    counters, per-job worker assignment) plus the per-job task and
    telemetry gauges — the same aggregation keys the single-job
    /metrics exports, with a ``job`` label."""
    lines = []

    def gauge(metric, value, **labels):
        lines.append(prometheus_line(metric, value, **labels))

    sched = status.get("sched", {})
    gauge("elasticdl_sched_pool_workers", sched.get("pool_workers", 0))
    gauge("elasticdl_sched_pending_jobs", sched.get("pending_jobs", 0))
    for op, count in sorted(sched.get("decisions", {}).items()):
        gauge("elasticdl_sched_decisions_total", count, op=op)
    assigned = sched.get("workers_assigned", {})
    for name, jstatus in sorted(status.get("jobs", {}).items()):
        labels = {"job": name}
        gauge("elasticdl_sched_workers_assigned",
              assigned.get(name, 0), **labels)
        gauge("elasticdl_sched_job_state",
              {"pending": 0, "running": 1, "finished": 2}.get(
                  jstatus.get("state"), -1),
              **labels)
        _task_gauges(lines, jstatus["tasks"],
                     jstatus.get("finished", False), **labels)
        _telemetry_gauges(lines, jstatus.get("telemetry"), **labels)
        for counter, value in jstatus.get("exec_counters",
                                          {}).items():
            gauge("elasticdl_worker_counter", value, name=counter,
                  **labels)
        if "rendezvous" in jstatus:
            gauge("elasticdl_rendezvous_epoch",
                  jstatus["rendezvous"]["epoch"], **labels)
            gauge("elasticdl_rendezvous_world_size",
                  len(jstatus["rendezvous"]["world"]), **labels)
    if "workers" in status:
        gauge("elasticdl_workers_live", len(status["workers"]["live"]))
    for phase, snap in sorted(sched.get("hists", {}).items()):
        # Scheduler decision latency (ResizeController tick / rebalance
        # phases) as native histograms.
        histogram_lines(lines, "elasticdl_sched_decision_seconds",
                        snap, phase=phase)
    _slo_gauges(lines, status.get("slo"))
    return "\n".join(lines) + "\n"


def serving_to_prometheus(status):
    """Serving-replica /metrics renderer (serving/server.py).

    ``status``: {"draining": bool, "models": {name: endpoint.stats()}}.
    """
    lines = [prometheus_line("elasticdl_serving_draining",
                             int(status.get("draining", False)))]
    for name, stats in sorted(status.get("models", {}).items()):
        counters = stats.get("counters", {})

        def gauge(metric, value, _model=name):
            lines.append(prometheus_line(metric, value, model=_model))

        gauge("elasticdl_serving_version", stats.get("version", 0))
        gauge("elasticdl_serving_requests",
              counters.get("batcher.requests", 0))
        gauge("elasticdl_serving_batches",
              counters.get("batcher.batches", 0))
        occupancy = stats.get("mean_batch_occupancy")
        if occupancy is not None:
            gauge("elasticdl_serving_occupancy", occupancy)
        wait = stats.get("timing", {}).get("batcher.queue_wait")
        if wait:
            gauge("elasticdl_serving_queue_wait_ms",
                  1e3 * wait["mean_s"])
        if stats.get("queue_wait_recent_ms") is not None:
            # Windowed recent queue wait straight from the replica's
            # own histogram (utils/hist.recent) — the router's probe
            # differencing is now a cross-check, not the only recent
            # signal.
            gauge("elasticdl_serving_queue_wait_recent_ms",
                  round(stats["queue_wait_recent_ms"], 3))
        hists = stats.get("hists", {})
        for phase, metric in (
                ("batcher.queue_wait",
                 "elasticdl_serving_queue_wait_seconds"),
                ("batcher.execute",
                 "elasticdl_serving_execute_seconds"),
                # Server-side request wall time (marshal + queue +
                # execute + encode), observed per request in the HTTP
                # handler for BOTH content types — the p99 the binary
                # data plane's bench gate reads (docs/serving.md
                # "Wire protocol").
                ("serving.request",
                 "elasticdl_serving_request_seconds")):
            if hists.get(phase):
                histogram_lines(lines, metric, hists[phase],
                                model=name)
        cache = stats.get("emb_cache")
        if cache:
            gauge("elasticdl_serving_emb_cache_bytes", cache["bytes"])
            gauge("elasticdl_serving_emb_cache_rows", cache["rows"])
            gauge("elasticdl_serving_emb_cache_evicted_rows",
                  cache["evicted_rows"])
            if cache.get("hit_ratio") is not None:
                gauge("elasticdl_serving_emb_cache_hit_ratio",
                      round(cache["hit_ratio"], 6))
    _slo_gauges(lines, status.get("slo"))
    return "\n".join(lines) + "\n"


def fleet_to_prometheus(status):
    """Router /metrics renderer (serving/router.py): the FLEET view —
    committed version, per-replica health/load/version, routing
    counters.

    ``status``: the router's ``fleet_status()`` dict.
    """
    lines = [
        prometheus_line("elasticdl_fleet_committed_version",
                        status.get("committed_version", 0)),
        prometheus_line("elasticdl_fleet_replicas_healthy",
                        sum(1 for r in status.get("replicas", {})
                            .values() if r.get("healthy"))),
        prometheus_line("elasticdl_fleet_replicas_total",
                        len(status.get("replicas", {}))),
    ]
    for addr, rep in sorted(status.get("replicas", {}).items()):
        def gauge(metric, value, _addr=addr):
            lines.append(prometheus_line(metric, value, replica=_addr))

        gauge("elasticdl_fleet_replica_healthy",
              int(rep.get("healthy", False)))
        gauge("elasticdl_fleet_replica_serving_version",
              rep.get("serving_version", 0))
        gauge("elasticdl_fleet_replica_inflight",
              rep.get("inflight", 0))
        if rep.get("queue_wait_ms") is not None:
            gauge("elasticdl_fleet_replica_queue_wait_ms",
                  rep["queue_wait_ms"])
        if rep.get("queue_wait_recent_ms") is not None:
            gauge("elasticdl_fleet_replica_queue_wait_recent_ms",
                  round(rep["queue_wait_recent_ms"], 3))
    for addr, snap in sorted(
            (status.get("latency_hists") or {}).items()):
        # Per-replica end-to-end forward latency as a native
        # histogram — the router-side view of each replica's tail.
        histogram_lines(lines, "elasticdl_fleet_replica_latency_seconds",
                        snap, replica=addr)
    for name, value in sorted(status.get("counters", {}).items()):
        lines.append(prometheus_line("elasticdl_fleet_router_counter",
                                     value, name=name))
    canary = status.get("canary") or {}
    lines.append(prometheus_line("elasticdl_fleet_canary_active",
                                 int(bool(canary.get("active")))))
    if canary.get("active"):
        lines.append(prometheus_line("elasticdl_fleet_canary_version",
                                     canary.get("version", 0)))
        lines.append(prometheus_line(
            "elasticdl_fleet_canary_fraction",
            canary.get("fraction", 0.0)))
        lines.append(prometheus_line(
            "elasticdl_fleet_canary_replicas",
            len(canary.get("replicas", []))))
    for cohort, c in sorted((canary.get("cohorts") or {}).items()):
        def gauge(metric, value, _cohort=cohort):
            lines.append(prometheus_line(metric, value,
                                         cohort=_cohort))

        gauge("elasticdl_fleet_canary_requests", c.get("requests", 0))
        gauge("elasticdl_fleet_canary_keyed_requests",
              c.get("keyed_requests", 0))
        gauge("elasticdl_fleet_canary_errors", c.get("errors", 0))
        if c.get("requests"):
            gauge("elasticdl_fleet_canary_latency_ms",
                  round(c.get("latency_ms_sum", 0.0)
                        / c["requests"], 3))
        gauge("elasticdl_fleet_canary_model_version",
              c.get("model_version", 0))
        if c.get("latency_hist"):
            # Per-cohort latency distribution: the promote-or-rollback
            # evidence as a real p99, not a mean.
            histogram_lines(lines,
                            "elasticdl_fleet_cohort_latency_seconds",
                            c["latency_hist"], cohort=cohort)
    agg = status.get("aggregation") or {}
    if agg.get("freshness_seconds") is not None:
        # The aggregation tier's publish-freshness SLO telemetry
        # (docs/serving.md "The online loop"): rides in on
        # /fleet/rollout + /fleet/canary posts so the whole loop
        # scrapes at ONE point — the router.
        lines.append(prometheus_line("elasticdl_agg_freshness_seconds",
                                     round(agg["freshness_seconds"],
                                           3)))
        lines.append(prometheus_line(
            "elasticdl_agg_published_version", agg.get("version", 0)))
    _slo_gauges(lines, status.get("slo"))
    return "\n".join(lines) + "\n"


def ps_to_prometheus(status):
    """PS-shard /metrics renderer (ps/server.py status server):
    version/generation/durable gauges, request counters, and the
    push/pull handle-time histograms (docs/observability.md)."""
    lines = [
        prometheus_line("elasticdl_ps_version", status["version"]),
        prometheus_line("elasticdl_ps_generation",
                        status["generation"]),
        prometheus_line("elasticdl_ps_durable_version",
                        status["durable_version"]),
        prometheus_line("elasticdl_ps_initialized",
                        int(status["initialized"])),
    ] + [
        prometheus_line("elasticdl_ps_requests", count, kind=kind)
        for kind, count in sorted(status["counters"].items())
    ] + [
        prometheus_line("elasticdl_ps_wire_bytes", count, kind=kind)
        for kind, count in sorted(status.get("wire", {}).items())
    ]
    for phase, metric in (
            ("ps.push_handle", "elasticdl_ps_push_handle_seconds"),
            ("ps.pull_dense", "elasticdl_ps_pull_dense_seconds"),
            ("ps.pull_embedding",
             "elasticdl_ps_pull_embedding_seconds")):
        snap = status.get("hists", {}).get(phase)
        if snap:
            histogram_lines(lines, metric, snap)
    _slo_gauges(lines, status.get("slo"))
    return "\n".join(lines) + "\n"
