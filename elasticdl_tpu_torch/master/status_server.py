"""Master HTTP status endpoint — the operator observability surface
(counterpart of ``elasticdl_tpu/master/status_server.py``).

The reference surfaces job state through logs and the k8s API (pod
phases, the job monitor); this gives operators and probes a direct
pull surface on the master itself:

  GET /healthz   -> 200 "ok" (liveness/readiness probe target)
  GET /status    -> JSON: task counts (todo/doing/completed/failed,
                    epoch), live workers, rendezvous epoch + world,
                    worker exec counters, per-worker training telemetry
  GET /metrics   -> the same numbers in Prometheus text exposition
                    format (elasticdl_tasks_todo, ..._completed{type=},
                    elasticdl_workers_live, elasticdl_rendezvous_epoch)
  GET /tracez    -> the process flight recorder (utils/tracing.py);
                    ?fmt=chrome renders Chrome trace-event JSON for
                    Perfetto (docs/observability.md)
  GET /alertz    -> the SLO watchdog's live rule table
                    (utils/slo.py: value vs threshold, ok, breach
                    episodes)
  GET /profilez?secs=N -> capture a torch.profiler trace (utils/timing.py
                    ``TorchProfiler``: Chrome-trace JSON, CUDA activity
                    only in a process that already initialised CUDA)
                    for N seconds into $ELASTICDL_TRACE_DIR; the reply
                    (and a profile.capture flight-recorder event)
                    carries the capture dir + current trace id, so a
                    Perfetto profile links to its /tracez trace

Stdlib-only (ThreadingHTTPServer), read-only, zero coupling into the
control plane beyond the objects it snapshots.  Enabled with
``--status_port`` (master flag); port 0 picks a free one.

The Prometheus renderers live in ``utils/prom.py`` (single escaping /
labels implementation for the whole system); this module re-exports
them so historical imports keep working.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from elasticdl_tpu_torch.utils import slo as slo_mod
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.prom import (  # noqa: F401  (re-exported API)
    fleet_to_prometheus,
    multitenant_to_prometheus,
    prometheus_line,
    serving_to_prometheus,
    to_prometheus,
)

logger = get_logger(__name__)


def collect_status(task_manager, worker_manager=None,
                   rendezvous_server=None, servicer=None):
    status = {"tasks": task_manager.counts(),
              "finished": task_manager.finished()}
    if worker_manager is not None:
        status["workers"] = {
            "live": sorted(worker_manager.live_worker_ids()),
        }
    if rendezvous_server is not None:
        status["rendezvous"] = {
            "epoch": rendezvous_server.rendezvous_id,
            "world": rendezvous_server.world,
        }
    if servicer is not None:
        status["exec_counters"] = dict(servicer.worker_exec_counters)
        telemetry = servicer.telemetry()
        if telemetry["workers"]:
            # Per-worker steps/s, sync_fraction, push staleness,
            # fused-window stats piggybacked on the coalesced progress
            # RPCs — the resize-controller sensor input (ROADMAP 5).
            status["telemetry"] = telemetry
        rpc_hists = servicer.rpc_histograms()
        if rpc_hists:
            # Master RPC handle-time histograms (get_task / progress /
            # result reports) — rendered as native Prometheus
            # histograms by utils/prom.py.
            status["rpc_hists"] = rpc_hists
        ps_state = servicer.ps_state()
        if ps_state:
            # PS recovery plane (docs/ps_recovery.md): per-shard
            # generation/durable version plus the cross-shard commit
            # mark — the version a PS restore would come back at.
            status["ps"] = {
                "shards": ps_state,
                "commit_mark": servicer.ps_commit_mark(),
            }
    slo = slo_mod.slo_section()
    if slo is not None:
        status["slo"] = slo
    return status


class HttpStatusServer:
    """Generic /healthz /status /metrics /tracez server over a
    collect_fn (returns the JSON-able status dict) and a prom_fn
    (renders it as Prometheus text).  The master's StatusServer and
    the PS's metrics endpoint are both instances."""

    def __init__(self, collect_fn, prom_fn, port=0, host="0.0.0.0"):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("status: " + fmt, *args)

            def _reply(self, code, body, content_type):
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._reply(200, "ok\n", "text/plain")
                if tracing.is_tracez_path(self.path):
                    # Live flight-recorder query: independent of
                    # collect_fn so a wedged control plane can still
                    # be traced.
                    return self._reply(
                        200, tracing.tracez_body(self.path),
                        "application/json")
                if slo_mod.is_alertz_path(self.path):
                    # The SLO watchdog surface — also independent of
                    # collect_fn (evaluation reads its own sources).
                    return self._reply(
                        200, slo_mod.alertz_body(),
                        "application/json")
                if tracing.is_profilez_path(self.path):
                    # On-demand torch profiler capture; blocks THIS
                    # request thread for the capture window only.
                    return self._reply(
                        200, tracing.profilez_body(self.path),
                        "application/json")
                try:
                    status = collect_fn()
                except Exception as e:  # noqa: BLE001 — a probe must
                    # get a 500, not a dropped connection
                    return self._reply(500, "error: %s\n" % e,
                                       "text/plain")
                if self.path == "/status":
                    return self._reply(200, json.dumps(status),
                                       "application/json")
                if self.path == "/metrics":
                    return self._reply(
                        200, prom_fn(status),
                        "text/plain; version=0.0.4")
                return self._reply(404, "unknown path %s\n" % self.path,
                                   "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="status-http",
            daemon=True,
        )

    def start(self):
        self._thread.start()
        logger.info("status server on port %d "
                    "(/healthz /status /metrics /tracez)", self.port)

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class StatusServer(HttpStatusServer):
    def __init__(self, task_manager, worker_manager=None,
                 rendezvous_server=None, servicer=None, port=0,
                 host="0.0.0.0"):
        super().__init__(
            lambda: collect_status(
                task_manager, worker_manager=worker_manager,
                rendezvous_server=rendezvous_server,
                servicer=servicer,
            ),
            to_prometheus, port=port, host=host,
        )


def collect_multitenant_status(registry, worker_manager=None):
    """The multi-tenant master's /status payload: the scheduler view
    (pool, admission queue, assignment map, decision counters) plus a
    per-job section reusing the single-job surfaces — task counts, the
    per-job telemetry aggregate (the resize controller's sensor input)
    and the job's rendezvous epoch (docs/scheduler.md)."""
    status = {"sched": registry.status(), "jobs": {}}
    for job in registry.jobs():
        entry = {
            "id": job.job_id,
            "state": job.state,
            "tasks": job.task_manager.counts(),
            "finished": job.task_manager.finished(),
            "telemetry": job.servicer.telemetry(),
            "exec_counters": dict(job.servicer.worker_exec_counters),
        }
        if job.rendezvous is not None:
            entry["rendezvous"] = {
                "epoch": job.rendezvous.rendezvous_id,
                "world": job.rendezvous.world,
            }
        status["jobs"][job.spec.name] = entry
    if worker_manager is not None:
        status["workers"] = {
            "live": sorted(worker_manager.live_worker_ids()),
        }
    slo = slo_mod.slo_section()
    if slo is not None:
        status["slo"] = slo
    return status


class MultiTenantStatusServer(HttpStatusServer):
    def __init__(self, registry, worker_manager=None, port=0,
                 host="0.0.0.0"):
        super().__init__(
            lambda: collect_multitenant_status(
                registry, worker_manager=worker_manager,
            ),
            multitenant_to_prometheus, port=port, host=host,
        )
