"""Aggregation-tier entrypoint: the daemon that closes the loop.

One single-threaded control loop (docs/serving.md "The online loop"):

  ingest trainer exports  ->  aggregate window  ->  publish servable
        ->  drive the fleet rollout (direct, or canary-first)
        ->  retention GC (never the committed version or newer)

The fleet half goes through the ROUTER's control API
(serving/router.py): ``POST /fleet/rollout`` hands the router's
coordinator one published version to take through its prepare→warm→
barrier→commit protocol (the router owns the admission gate — the
barrier is only correct there), and the canary endpoints slice p% of
the key ring onto canary replicas first, with promote/rollback decided
here off the router's own per-cohort error counters.  Run the router
with ``--auto_rollout false`` so this tier is the only rollout minter.

Run:
  python -m elasticdl_tpu_torch.aggregation.main \
      --source_dir TRAINER_EXPORTS --publish_dir FLEET_EXPORTS \
      --router_addr host:8500 [--window 4 --agg_mode ema]
      [--freshness_slo_secs 10] [--export_keep 8]
      [--canary_fraction 0.25 --canary_soak_secs 20]
"""

import http.client
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from elasticdl_tpu_torch.aggregation.aggregator import (
    ModelAggregator,
    ProgramMissingError,
)
from elasticdl_tpu_torch.serving.fleet import http_get_json, http_post_json
from elasticdl_tpu_torch.utils import tensor_codec, tracing
from elasticdl_tpu_torch.utils.args import build_aggregator_parser
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# The ingest endpoint refuses bodies whose declared length exceeds
# this — a lying Content-Length must not balloon the daemon before the
# codec even sees the bytes (the frame preamble re-checks the real
# length anyway).
INGEST_MAX_BYTES = 1 << 31


class IngestServer:
    """The aggregator's cross-host streamed-ingest surface.

      POST /ingest   -> one ``model.frame`` blob
                        (``ContinuousExporter.frame_bytes``); replies
                        200 {"ingested": version} on success
      GET  /healthz  -> 200 ok
      GET  /status   -> the aggregator's ``stats()`` JSON

    Rejections map to DISTINCT statuses because the exporter's
    recovery differs per cause (docs/serving.md "Streamed ingest"):

      400  malformed frame (codec ``FrameError``) — a bug or hostile
           peer; the body is discarded loudly, never partially applied
      409  stale version (the version-monotone rule) — skip; a
           re-formed elastic world double-sent an old cadence
      415  not the frame content type — this endpoint speaks only the
           binary wire
      422  program missing — the frame's parameter tree is new here
           and no StableHLO program rode along (this aggregator
           restarted and lost its cache); the exporter re-sends with
           ``include_program=True``

    Ingest runs on the HTTP thread but mutates the aggregator under
    ``agg.loop_lock`` (inside ``ingest_frame``), serializing against
    the control loop — the single-threaded-aggregator design holds
    with this surface attached.  This is the real three-host topology:
    trainer and aggregator share no filesystem; versions arrive ONLY
    through this endpoint."""

    def __init__(self, agg, port=0, host="0.0.0.0"):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive for streams

            def log_message(self, fmt, *args):
                logger.debug("ingest: " + fmt, *args)

            def _reply(self, code, payload, close=False):
                # ``close``: a POST rejected BEFORE its body was read
                # leaves the unread bytes in the keep-alive stream —
                # the next pipelined request would parse mid-body.
                # Those rejections tear the connection down instead.
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if close:
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._reply(200, {"ok": True})
                if self.path == "/status":
                    return self._reply(200, agg.stats())
                return self._reply(404, {"error": "unknown path %s"
                                         % self.path})

            def do_POST(self):
                if self.path != "/ingest":
                    return self._reply(404, {"error": "unknown path "
                                             "%s" % self.path},
                                       close=True)
                if not tensor_codec.is_frame_content_type(
                        self.headers.get("Content-Type", "")):
                    return self._reply(415, {
                        "error": "POST /ingest takes %s bodies"
                        % tensor_codec.FRAME_CONTENT_TYPE},
                        close=True)
                try:
                    length = int(self.headers.get("Content-Length",
                                                  0))
                except ValueError:
                    length = -1
                if not 0 < length <= INGEST_MAX_BYTES:
                    return self._reply(400, {
                        "error": "bad Content-Length %r"
                        % self.headers.get("Content-Length")},
                        close=True)
                blob = self.rfile.read(length)
                try:
                    version = agg.ingest_frame(blob,
                                               require_program=True)
                except tensor_codec.FrameError as e:
                    agg.bump("ingest_frame_rejected")
                    logger.warning("ingest refused a bad frame: %s",
                                   e)
                    return self._reply(400, {"error": "bad frame: %s"
                                             % e})
                except ProgramMissingError as e:
                    logger.warning("ingest needs a program: %s", e)
                    return self._reply(422, {"error": str(e)})
                if version is None:
                    return self._reply(409, {
                        "error": "stale version (monotone ingest)",
                        "last_ingested":
                            agg.stats()["last_ingested_version"]})
                return self._reply(200, {"ingested": version})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ingest-http",
            daemon=True)

    def start(self):
        self._thread.start()
        logger.info("streamed-ingest endpoint on port %d "
                    "(POST /ingest)", self.port)

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

# Everything a dying/garbled router can throw at this client: OSError
# covers refusals and non-200s (http_post_json raises it), ValueError
# covers malformed reply bodies, HTTPException covers a connection cut
# mid-reply (BadStatusLine/LineTooLong are NOT OSErrors) — the daemon
# must retry on the next publish, never exit.
_FLEET_ERRORS = (OSError, ValueError, http.client.HTTPException)


class RouterClient:
    """Thin HTTP client for the router's fleet-control surface."""

    def __init__(self, addr, timeout=10.0, rollout_timeout=300.0):
        self.addr = addr
        self.timeout = timeout
        self.rollout_timeout = rollout_timeout

    def rollout(self, version, freshness=None):
        """Fleet-wide barrier rollout of ``version``; blocks until the
        router's coordinator finished (or refused).  ``freshness``
        rides along so the router can export
        ``elasticdl_agg_freshness_seconds`` — the fleet's /metrics is
        the one scrape point for the whole loop."""
        return http_post_json(
            self.addr, "/fleet/rollout",
            {"version": int(version),
             "freshness_seconds": freshness},
            self.rollout_timeout)

    def canary_start(self, version, fraction, freshness=None):
        return http_post_json(
            self.addr, "/fleet/canary",
            {"version": int(version), "fraction": float(fraction),
             "freshness_seconds": freshness},
            self.rollout_timeout)

    def canary_promote(self):
        return http_post_json(self.addr, "/fleet/canary/promote", {},
                              self.rollout_timeout)

    def canary_rollback(self):
        return http_post_json(self.addr, "/fleet/canary/rollback", {},
                              self.rollout_timeout)

    def status(self):
        return http_get_json(self.addr, "/fleet/status", self.timeout)

    def committed_version(self):
        try:
            return int(self.status().get("committed_version", 0))
        except _FLEET_ERRORS:
            return None


def _cohort_counters(status, cohort):
    canary = status.get("canary") or {}
    return (canary.get("cohorts") or {}).get(cohort) or {}


def _rollout_recovering(router, version, freshness):
    """One plain rollout, recovering from a stale canary: a rollout
    refused because a canary is still active rolls the canary back
    and retries ONCE — otherwise a single failed promote would wedge
    every future publish behind the standing slice."""
    result = router.rollout(version, freshness)
    if not result.get("committed") and "canary active" in (
            result.get("error") or ""):
        logger.warning("rollout of %d blocked by a stale canary; "
                       "rolling it back and retrying", version)
        router.canary_rollback()
        result = router.rollout(version, freshness)
    return result


def drive_rollout(router, version, freshness=None,
                  canary_fraction=0.0, canary_soak_secs=10.0,
                  canary_max_error_ratio=0.02, stop_event=None,
                  promote=True):
    """Take one published version through the fleet: plain barrier
    rollout, or canary-first — slice ``canary_fraction`` of the key
    ring onto canary replicas, soak, then promote barrier-clean if the
    canary cohort's error ratio stays under the budget, else roll
    back.  Returns the router's committed version afterwards (the
    retention-GC floor), or None when the router was unreachable."""
    stop_event = stop_event or threading.Event()
    try:
        if canary_fraction <= 0.0:
            result = _rollout_recovering(router, version, freshness)
            logger.info("rollout of %d: %s", version, result)
            return router.committed_version()
        started = router.canary_start(version, canary_fraction,
                                      freshness)
        if not started.get("started"):
            error = started.get("error") or ""
            if "already active" in error:
                # A STALE canary (a previous promote's barrier timed
                # out and left the slice standing) wedges every later
                # rollout; roll it back so the loop recovers instead
                # of silently violating the freshness SLO forever.
                logger.warning("stale canary blocks version %d (%s); "
                               "rolling it back", version, error)
                router.canary_rollback()
            else:
                # No replica to slice out (single-replica fleet):
                # freshness must not stall behind an impossible
                # canary.
                logger.info("canary of %d not started (%s); plain "
                            "rollout", version, error)
            _rollout_recovering(router, version, freshness)
            return router.committed_version()
        before = _cohort_counters(router.status(), "canary")
        stop_event.wait(canary_soak_secs)
        after = _cohort_counters(router.status(), "canary")
        requests = (after.get("requests", 0)
                    - before.get("requests", 0))
        errors = after.get("errors", 0) - before.get("errors", 0)
        ratio = (errors / requests) if requests else None
        # Promotion needs EVIDENCE: a soak that saw zero canary
        # traffic — or one cut short by shutdown — proves nothing,
        # and an evidence-free promote is exactly what the canary
        # gate exists to prevent.  Roll back; the next publish
        # retries with a fresh version.
        healthy = (ratio is not None
                   and ratio <= canary_max_error_ratio
                   and not stop_event.is_set())
        logger.info(
            "canary of %d soaked %.1fs: %d requests, %d errors "
            "(ratio %s, budget %.4f) -> %s", version,
            canary_soak_secs, requests, errors,
            "%.4f" % ratio if ratio is not None else "no evidence",
            canary_max_error_ratio,
            "promote" if healthy and promote else "rollback")
        if healthy and promote:
            router.canary_promote()
        else:
            router.canary_rollback()
        return router.committed_version()
    except _FLEET_ERRORS as e:
        # The publish stands, only the rollout is lost — the next
        # publish retries the fleet.
        logger.warning("fleet drive for version %d failed: %s",
                       version, e)
        return None


def run_loop(agg, stop_event, router=None, poll_interval=1.0,
             canary_fraction=0.0, canary_soak_secs=10.0,
             canary_max_error_ratio=0.02):
    """The aggregation tier's control loop (see module docstring).

    Aggregator mutations run under ``agg.loop_lock`` — the streamed-
    ingest HTTP endpoint shares the aggregator from its own threads —
    but never across the fleet drive: a 300 s rollout must not starve
    ingest."""
    while not stop_event.is_set():
        with agg.loop_lock:
            agg.ingest_once()
        if agg.publish_due():
            try:
                with agg.loop_lock:
                    version, freshness = agg.publish()
            except (OSError, RuntimeError) as e:
                logger.warning("publish failed: %s", e)
                agg.bump("publish_errors")
            else:
                if router is not None:
                    # Unreachable router -> floor None -> no GC (the
                    # fleet's committed version is unknown).
                    floor = drive_rollout(
                        router, version, freshness,
                        canary_fraction=canary_fraction,
                        canary_soak_secs=canary_soak_secs,
                        canary_max_error_ratio=canary_max_error_ratio,
                        stop_event=stop_event)
                else:
                    # Publish-only mode: nothing downstream reports a
                    # committed version, so the newest publish IS the
                    # floor — retention still runs, or the base would
                    # grow without bound despite --export_keep.
                    floor = version
                agg.gc_published(committed_floor=floor)
        stop_event.wait(poll_interval)


def main(argv=None):
    import signal

    args = build_aggregator_parser().parse_args(argv)
    tracing.configure_identity("aggregator")
    tracing.arm_crash_dump()
    agg = ModelAggregator(
        args.source_dir, args.publish_dir,
        window=args.window, mode=args.agg_mode,
        ema_decay=args.ema_decay,
        freshness_slo_secs=args.freshness_slo_secs,
        min_publish_interval_secs=args.publish_interval_secs,
        export_keep=args.export_keep,
        model_name=args.model_name,
    )
    router = (RouterClient(args.router_addr) if args.router_addr
              else None)
    ingest_server = None
    if args.ingest_port >= 0:
        ingest_server = IngestServer(agg, port=args.ingest_port)
        ingest_server.start()
    stop = threading.Event()

    def on_term(_signum, _frame):
        stop.set()

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread (embedded use)
    logger.info(
        "aggregation tier: %s -> %s (window %d, mode %s, SLO %.1fs, "
        "keep %d, router %s, canary %.2f)", args.source_dir,
        args.publish_dir, args.window, args.agg_mode,
        args.freshness_slo_secs, args.export_keep,
        args.router_addr or "-", args.canary_fraction)
    try:
        run_loop(agg, stop, router=router,
                 poll_interval=args.poll_interval,
                 canary_fraction=args.canary_fraction,
                 canary_soak_secs=args.canary_soak_secs,
                 canary_max_error_ratio=args.canary_max_error_ratio)
    except KeyboardInterrupt:
        pass
    if ingest_server is not None:
        ingest_server.stop()
    logger.info("aggregation tier stopping: %s", agg.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
