"""THE registry of every ``elasticdl_*`` Prometheus series.

One declaration point for every series name any surface emits, with a
one-line meaning — enforced mechanically:

 - **elastic-lint EL010** parses this module and fails on any
   ``prometheus_line``/``histogram_lines`` call whose literal metric
   name is not declared here (typo'd series), and on duplicate
   declarations.  An undeclared name is a lint failure, not a silent
   new series.
 - **tests/test_prom_exposition.py** scrapes every renderer and
   checks emitted names against this table, and cross-checks the
   ``elasticdl_*`` tokens in the docs' metric tables — docs cannot
   drift from the registry.

Conventions:

 - ``*_seconds`` names declared with ``histogram=True`` are native
   Prometheus histograms (utils/prom.histogram_lines): the scraped
   series are ``<name>_bucket{le=}``, ``<name>_sum``, ``<name>_count``
   over the fixed utils/hist.py boundary set.
 - A ``%s`` in a name is a render-time template (the EL010 matcher
   treats it as ``[a-z0-9_]+``); list the known expansions in the
   description.
"""

import re

# name -> {"help": ..., "histogram": bool}
_G = lambda help_: {"help": help_, "histogram": False}  # noqa: E731
_H = lambda help_: {"help": help_, "histogram": True}   # noqa: E731

METRICS = {
    # -- master: tasks / job state ------------------------------------
    "elasticdl_tasks_todo": _G("tasks waiting for dispatch"),
    "elasticdl_tasks_doing": _G("tasks currently dispatched"),
    "elasticdl_tasks_%s": _G("task terminal counts by type: expands "
                             "to elasticdl_tasks_completed / "
                             "elasticdl_tasks_failed {type=}"),
    "elasticdl_tasks_completed": _G("completed tasks {type=}"),
    "elasticdl_tasks_failed": _G("permanently failed tasks {type=}"),
    "elasticdl_data_epoch": _G("current data epoch"),
    "elasticdl_job_finished": _G("1 when the job's task queue drained"),
    "elasticdl_workers_live": _G("workers the master considers live"),
    "elasticdl_worker_counter": _G("worker exec counters {name=}"),
    "elasticdl_rendezvous_epoch": _G("membership epoch"),
    "elasticdl_rendezvous_world_size": _G("current world size"),
    # -- master: telemetry aggregate ----------------------------------
    "elasticdl_job_steps_per_sec": _G("sum of fresh workers' steps/s"),
    "elasticdl_telemetry_workers_reporting": _G(
        "workers with a fresh telemetry report"),
    "elasticdl_worker_steps_per_sec": _G(
        "per-worker steps/s {worker=}"),
    "elasticdl_worker_sync_fraction": _G(
        "per-worker blocked-on-device share {worker=}"),
    "elasticdl_worker_push_staleness": _G(
        "per-worker PS push-pipeline depth {worker=}"),
    "elasticdl_worker_window_size": _G(
        "per-worker mean fused-window size {worker=}"),
    "elasticdl_worker_steps_done": _G(
        "per-worker lifetime optimizer steps {worker=}"),
    # -- master: percentile plane -------------------------------------
    "elasticdl_job_step_time_seconds": _H(
        "per-job step-time distribution: exact merge of worker "
        "histogram deltas (true p50/p99, not a mean of means)"),
    "elasticdl_worker_straggler": _G(
        "1 while the worker is sustained-flagged by the straggler "
        "detector {worker=}"),
    "elasticdl_worker_step_p50_seconds": _G(
        "per-worker windowed p50 step time the straggler sweep "
        "judged on {worker=}"),
    "elasticdl_master_rpc_handle_seconds": _H(
        "master RPC handle time {method=get_task|report_batch_done|"
        "report_task_result}"),
    # -- master: PS recovery plane ------------------------------------
    "elasticdl_ps_commit_mark": _G(
        "cross-shard min durable version (restore upper bound)"),
    "elasticdl_ps_shard_generation": _G(
        "per-shard restart generation {ps_id=}"),
    "elasticdl_ps_shard_durable_version": _G(
        "per-shard durable checkpoint version {ps_id=}"),
    # -- multi-tenant scheduler ---------------------------------------
    "elasticdl_sched_pool_workers": _G("shared pool size estimate"),
    "elasticdl_sched_pending_jobs": _G("jobs queued for admission"),
    "elasticdl_sched_decisions_total": _G(
        "scheduler decision counts {op=}"),
    "elasticdl_sched_workers_assigned": _G(
        "workers assigned to the job {job=}"),
    "elasticdl_sched_job_state": _G(
        "0 pending / 1 running / 2 finished {job=}"),
    "elasticdl_sched_decision_seconds": _H(
        "scheduler decision latency {phase=tick}"),
    # -- PS shard (ps/server.py status surface) -----------------------
    "elasticdl_ps_version": _G("shard model version"),
    "elasticdl_ps_generation": _G("shard restart generation"),
    "elasticdl_ps_durable_version": _G("last version durably on disk"),
    "elasticdl_ps_initialized": _G("1 once parameters initialized"),
    "elasticdl_ps_requests": _G("data-plane request counters {kind=}"),
    "elasticdl_ps_wire_bytes": _G(
        "data-plane payload + decode-copy bytes per wire encoding "
        "{kind=push_payload_frame|push_decode_copy_pb|...}"),
    "elasticdl_ps_push_handle_seconds": _H(
        "push_gradients handle time"),
    "elasticdl_ps_pull_dense_seconds": _H(
        "pull_dense_parameters handle time"),
    "elasticdl_ps_pull_embedding_seconds": _H(
        "pull_embedding_vectors handle time"),
    # -- serving replica ----------------------------------------------
    "elasticdl_serving_draining": _G("1 while SIGTERM-draining"),
    "elasticdl_serving_version": _G("serving model version {model=}"),
    "elasticdl_serving_requests": _G("batcher requests {model=}"),
    "elasticdl_serving_batches": _G("executed device batches {model=}"),
    "elasticdl_serving_occupancy": _G("mean batch occupancy {model=}"),
    "elasticdl_serving_queue_wait_ms": _G(
        "LIFETIME mean queue wait (historical; prefer the histogram) "
        "{model=}"),
    "elasticdl_serving_queue_wait_recent_ms": _G(
        "windowed recent queue wait from the replica's own histogram "
        "{model=}"),
    "elasticdl_serving_queue_wait_seconds": _H(
        "admission-queue wait distribution {model=}"),
    "elasticdl_serving_execute_seconds": _H(
        "device-batch execute distribution {model=}"),
    "elasticdl_serving_request_seconds": _H(
        "server-side request wall time (marshal+queue+execute+encode, "
        "JSON and binary content types) {model=}"),
    "elasticdl_serving_emb_cache_bytes": _G(
        "hot-row cache bytes {model=}"),
    "elasticdl_serving_emb_cache_rows": _G(
        "hot-row cache rows {model=}"),
    "elasticdl_serving_emb_cache_evicted_rows": _G(
        "hot-row cache LRU evictions {model=}"),
    "elasticdl_serving_emb_cache_hit_ratio": _G(
        "hot-row cache hit ratio {model=}"),
    # -- fleet router -------------------------------------------------
    "elasticdl_fleet_committed_version": _G(
        "the fleet's committed (barrier) version"),
    "elasticdl_fleet_replicas_healthy": _G("healthy replicas"),
    "elasticdl_fleet_replicas_total": _G("replicas in the table"),
    "elasticdl_fleet_replica_healthy": _G(
        "1 when the replica is routable {replica=}"),
    "elasticdl_fleet_replica_serving_version": _G(
        "replica serving version {replica=}"),
    "elasticdl_fleet_replica_inflight": _G(
        "router-side in-flight forwards {replica=}"),
    "elasticdl_fleet_replica_queue_wait_ms": _G(
        "replica lifetime mean queue wait (probe view) {replica=}"),
    "elasticdl_fleet_replica_queue_wait_recent_ms": _G(
        "replica recent queue wait: replica-reported, probe-"
        "differenced fallback {replica=}"),
    "elasticdl_fleet_replica_latency_seconds": _H(
        "router-observed end-to-end forward latency {replica=}"),
    "elasticdl_fleet_router_counter": _G(
        "router observability counters {name=}"),
    "elasticdl_fleet_canary_active": _G("1 while a canary is live"),
    "elasticdl_fleet_canary_version": _G("canary version"),
    "elasticdl_fleet_canary_fraction": _G("canary key-ring fraction"),
    "elasticdl_fleet_canary_replicas": _G("canary replica count"),
    "elasticdl_fleet_canary_requests": _G(
        "per-cohort requests {cohort=}"),
    "elasticdl_fleet_canary_keyed_requests": _G(
        "per-cohort keyed requests {cohort=}"),
    "elasticdl_fleet_canary_errors": _G(
        "per-cohort 5xx responses {cohort=}"),
    "elasticdl_fleet_canary_latency_ms": _G(
        "per-cohort mean latency (historical; prefer the cohort "
        "histogram) {cohort=}"),
    "elasticdl_fleet_canary_model_version": _G(
        "per-cohort last routed version {cohort=}"),
    "elasticdl_fleet_cohort_latency_seconds": _H(
        "per-cohort latency distribution — the promote/rollback "
        "evidence {cohort=}"),
    # -- aggregation tier (exported via the router) -------------------
    "elasticdl_agg_freshness_seconds": _G(
        "publish freshness (publish wall - export birth)"),
    "elasticdl_agg_published_version": _G(
        "last aggregated version published"),
    # -- SLO watchdog (every surface) ---------------------------------
    "elasticdl_slo_ok": _G("1 while the rule holds {rule=}"),
    "elasticdl_slo_breach_total": _G(
        "breach EPISODES (ok->breach transitions) {rule=}"),
}


def is_declared(name):
    """True when ``name`` (possibly a render-time ``%s`` template)
    matches a declared series — histogram suffixes resolve to their
    declared base name."""
    if name in METRICS:
        return True
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if METRICS.get(base, {}).get("histogram"):
                return True
    # a %s template matches iff some declared name matches its pattern
    if "%s" in name:
        pattern = re.compile(
            "^" + re.escape(name).replace("%s", "[a-z0-9_]+") + "$")
        return any(pattern.match(known) for known in METRICS)
    return False
