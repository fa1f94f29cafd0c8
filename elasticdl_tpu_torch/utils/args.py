"""Command-line flags of the port's entry points (counterpart of
``elasticdl_tpu/utils/args.py``): the master, worker, PS shard,
serving, fleet-router and aggregation-tier parsers.  Flags keep the JAX
package's names and defaults, so the master re-serializes its parsed
args into worker command lines (``build_arguments_from_parsed_result``)
and a worker of either package parses a master's flags.  A flag value
that selects a path the port has not ported yet would raise
``NotImplementedError`` naming its ROADMAP item (``check_ported``); no
flag value selects one now, and none is silently ignored."""

import argparse


def _str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def add_common_args(parser):
    parser.add_argument("--job_name", default="elasticdl-tpu-job")
    parser.add_argument("--job_type", default="train",
                        choices=["train", "evaluate", "predict"])
    parser.add_argument("--prediction_outputs", default="predictions",
                        help="output dir for predict jobs")
    parser.add_argument("--model_zoo", default="mnist",
                        help="zoo module name or dotted path")
    parser.add_argument("--model_params", default="",
                        help="k=v;k=v kwargs for model_spec() "
                             "(reference --model_def/--model_params)")
    parser.add_argument("--data_origin", default="synthetic_mnist",
                        help="dataset spec: synthetic_mnist[:n], csv path, "
                             "recio dir")
    parser.add_argument("--validation_data_origin", default="")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--num_minibatches_per_task", type=int, default=8)
    parser.add_argument("--distribution_strategy", default="local",
                        choices=["local", "collective", "ps"])
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--evaluation_steps", type=int, default=0)
    parser.add_argument("--log_loss_steps", type=int, default=100)
    parser.add_argument("--use_bf16", type=_str2bool, default=False)
    parser.add_argument("--zero1", type=_str2bool, default=False,
                        help="ZeRO-1 weight-update sharding in the "
                             "collective trainer: every optimizer-state "
                             "leaf is flattened, padded, and sharded "
                             "over the data axis (per-device optimizer "
                             "memory ~1/N, reported at startup), the "
                             "update runs shard-locally between a "
                             "reduce-scatter/all-gather pair, and "
                             "world re-forms re-partition live shards "
                             "device-to-device with Adam moments "
                             "preserved bit-exactly; loss trajectory "
                             "is bit-identical to the replicated "
                             "default (false = exact old path)")
    parser.add_argument("--fused_steps", type=int, default=1,
                        help="run up to K optimizer steps per device "
                             "dispatch in the worker hot loop "
                             "(fused-step driver; windows clamp to "
                             "report/checkpoint/log cadence "
                             "boundaries so elastic semantics are "
                             "unchanged); 1 = the exact per-step loop")
    parser.add_argument("--device_prefetch", type=int, default=2,
                        help="prepared-batch lookahead for the fused "
                             "driver: batch padding/reshape runs in "
                             "the prefetch producer and the next "
                             "window's host->device transfer is "
                             "staged behind the running step; 0 keeps "
                             "batch prep on the dispatch critical "
                             "path")
    parser.add_argument("--export_base", default="",
                        help="versioned servable export base for the "
                             "online-learning loop: worker 0 writes a "
                             "complete <base>/<version>/ servable "
                             "every --export_steps optimizer steps "
                             "(atomic publish; the aggregation tier "
                             "ingests from here — docs/serving.md "
                             "'The online loop'); empty = no "
                             "continuous export")
    parser.add_argument("--export_steps", type=int, default=0,
                        help="continuous-export cadence in optimizer "
                             "steps (0 = off); worker-0-only, the "
                             "same guard as checkpointing.  The "
                             "StableHLO program is traced once and "
                             "reused, so steady-state export cost is "
                             "one weight gather + one weights write")
    parser.add_argument("--export_wire", default="npz",
                        choices=("npz", "frame"),
                        help="continuous-export weight carrier: 'npz' "
                             "(standard archive, any loader) or "
                             "'frame' (the binary tensor wire format, "
                             "docs/serving.md 'Wire protocol': the "
                             "aggregation tier decodes model.frame as "
                             "zero-copy views — no zip container on "
                             "the export/ingest hot path)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", default="",
                        help="write a torch.profiler trace (Chrome-trace "
                             "JSON, <role>-<worker id>-<pid>.pt.trace.json) "
                             "of the worker run to this directory")


def build_master_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.master")
    add_common_args(parser)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="0 = workers launched externally")
    parser.add_argument("--num_ps", type=int, default=0)
    parser.add_argument("--use_async", type=_str2bool, default=True)
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    # Forwarded to PS workers (see worker parser for semantics).
    parser.add_argument("--async_push_window", type=int, default=1)
    parser.add_argument("--get_model_steps", type=int, default=1)
    parser.add_argument("--ps_wire_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--shuffle", type=_str2bool, default=False)
    parser.add_argument("--shuffle_shards", type=_str2bool, default=False)
    parser.add_argument("--max_task_retries", type=int, default=3)
    parser.add_argument("--task_timeout_secs", type=float, default=300)
    parser.add_argument("--relaunch_on_worker_failure", type=int, default=3)
    # k8s worker backend (in-cluster master; reference pod_manager flags)
    parser.add_argument("--worker_backend", default="process",
                        choices=["process", "k8s"])
    parser.add_argument("--image", default="elasticdl-tpu:latest",
                        help="worker container image (k8s backend)")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--worker_resource_request",
                        default="cpu=1,memory=2Gi",
                        help="k8s resources per worker pod")
    parser.add_argument("--tpu_topology", default="",
                        help="gke-tpu-topology node selector value")
    parser.add_argument("--worker_pod_priority", type=float, default=0.0,
                        help="fraction of workers on the high priority "
                             "class (reference --worker_pod_priority)")
    parser.add_argument("--cluster_spec", default="",
                        help="dotted module with patch_pod/patch_service "
                             "hooks")
    parser.add_argument("--status_port", type=int, default=-1,
                        help="HTTP observability port on the master "
                             "(/healthz /status /metrics); 0 = any "
                             "free port, -1 (default) = disabled")
    parser.add_argument("--journal_dir", default="",
                        help="job-state journal directory "
                             "(master/journal.py): task lifecycle, "
                             "progress counts and rendezvous epochs "
                             "are logged append-only + fsync'd; a "
                             "master relaunched with the same "
                             "--journal_dir replays it, requeues "
                             "in-flight tasks and resumes the job "
                             "exactly — workers ride the outage and "
                             "reconnect without restarting (empty = "
                             "no journal, master crash kills the job)")
    parser.add_argument("--rpc_fault_spec", default="",
                        help="deterministic RPC fault injection on "
                             "the master service (drills/tests): "
                             "'seed=N;method:every=7,code=unavailable;"
                             "*:down=5~10' — per-method seeded "
                             "error/delay/blackhole schedules, see "
                             "docs/master_recovery.md (empty = off)")
    parser.add_argument("--ps_rpc_fault_spec", default="",
                        help="deterministic RPC fault injection on the "
                             "launched PS shards (worker->PS "
                             "direction): forwarded by PSManager as "
                             "each shard's --rpc_fault_spec — same "
                             "grammar as --rpc_fault_spec (empty = "
                             "off)")
    parser.add_argument("--volume", default="",
                        help="pod volume mounts, reference syntax: "
                             "'claim_name=c,mount_path=/p;"
                             "host_path=/d,mount_path=/p2'")
    # Multi-tenant scheduler (master/scheduler.py, docs/scheduler.md)
    parser.add_argument("--jobs_spec", default="",
                        help="multi-tenant mode: JSON list of job "
                             "specs (inline, or a path to a .json "
                             "file) — each entry {name, data_origin, "
                             "model_zoo, num_epochs, min_workers, "
                             "max_workers, weight, ...}; unset fields "
                             "default to this master's own common "
                             "flags.  The J jobs share one worker "
                             "pool (--num_workers) under the resize "
                             "controller; empty = classic single-job "
                             "master")
    parser.add_argument("--sched_cadence_secs", type=float, default=1.0,
                        help="resize-controller policy cadence: each "
                             "tick sweeps finished jobs, admits "
                             "queued ones, recomputes per-job worker "
                             "targets and applies moves")
    parser.add_argument("--sched_moves_per_tick", type=int, default=1,
                        help="max worker re-assignments per controller "
                             "tick — a resize drains one worker at a "
                             "time by default, each move its own "
                             "journaled, traced decision")
    parser.add_argument("--sched_worker_stale_secs", type=float,
                        default=300.0,
                        help="a pool worker silent for this long is "
                             "evicted from the schedule (its tasks "
                             "requeue without burning retries); "
                             "bounds ghost assignments after a "
                             "master restart.  Keep it >= the longest "
                             "single task: progress/metric reports "
                             "count as life, but a PREDICTION task "
                             "reports only at its end")
    return parser


def build_worker_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.worker")
    add_common_args(parser)
    parser.add_argument("--master_addr", default="")
    parser.add_argument("--worker_id", type=int, default=-1)
    parser.add_argument("--ps_addrs", default="",
                        help="comma-separated parameter server addresses")
    parser.add_argument("--use_async", type=_str2bool, default=True,
                        help="PS mode; sync (False) selects the atomic "
                             "prepare/commit gradient push")
    parser.add_argument("--async_push_window", type=int, default=1,
                        help="max gradient pushes in flight behind the "
                             "compute (async PS jobs); 0 = serialized "
                             "blocking push; ignored in sync mode, "
                             "which stays strictly ordered")
    parser.add_argument("--get_model_steps", type=int, default=1,
                        help="pull dense params every N steps; each "
                             "pull drains the push pipeline, so N > 1 "
                             "is what lets the async push window "
                             "actually overlap compute")
    parser.add_argument("--ps_wire_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="on-wire encoding for pushed gradients and "
                             "pulled embedding rows; bfloat16 halves "
                             "the PS bandwidth, the PS still "
                             "accumulates in float32")
    return parser


def build_ps_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.ps")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--ps_id", type=int, default=0)
    parser.add_argument("--num_ps", type=int, default=1)
    parser.add_argument("--master_addr", default="")
    parser.add_argument("--opt_type", default="sgd")
    parser.add_argument("--opt_args", default="learning_rate=0.1",
                        help="k=v;k=v optimizer arguments")
    parser.add_argument("--use_async", type=_str2bool, default=True)
    parser.add_argument("--grads_to_wait", type=int, default=1)
    parser.add_argument("--sync_version_tolerance", type=int, default=0)
    parser.add_argument("--lr_staleness_modulation", type=_str2bool,
                        default=False)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--generation", type=int, default=0,
                        help="restart-generation hint from the "
                             "launcher (PSManager passes its per-shard "
                             "launch count); the shard serves as "
                             "max(persisted+1, hint, 1) — see "
                             "docs/ps_recovery.md")
    parser.add_argument("--evaluation_steps", type=int, default=0)
    parser.add_argument("--status_port", type=int, default=-1,
                        help="HTTP observability port (/healthz "
                             "/status /metrics); 0 = any free port, "
                             "-1 (default) = disabled")
    parser.add_argument("--rpc_delay_ms", type=float, default=0.0,
                        help="benchmark aid: add fixed latency to every "
                             "RPC to emulate a cross-host link on a "
                             "single-host rig (0 = off)")
    parser.add_argument("--rpc_fault_spec", default="",
                        help="deterministic RPC fault injection on the "
                             "PS service (same grammar as the master "
                             "flag; docs/master_recovery.md)")
    return parser


def add_serving_args(parser):
    """Model-server flags (serving/server.py) — the TF-Serving
    batching-config role, in-process."""
    parser.add_argument("--export_dir", required=True,
                        help="one export dir, or several as "
                             "name1=dir1,name2=dir2 (the TF-Serving "
                             "model-config role)")
    parser.add_argument("--model_name", default=None)
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--poll_interval", type=float, default=2.0,
                        help="seconds between version re-scans of a "
                             "TF-Serving-style <base>/<N>/ export dir")
    parser.add_argument("--enable_batching", type=_str2bool,
                        default=True,
                        help="dynamic request micro-batching "
                             "(serving/batcher.py); false restores the "
                             "serialized per-request execution path")
    parser.add_argument("--max_batch_size", type=int, default=32,
                        help="row cap per coalesced predict batch; 1 "
                             "also disables batching entirely")
    parser.add_argument("--batch_timeout_ms", type=float, default=2.0,
                        help="max time the executor waits to fill a "
                             "batch; a lone request is flushed after "
                             "at most this long (the latency floor / "
                             "throughput tradeoff knob)")
    parser.add_argument("--pad_buckets", default="",
                        help="comma-separated batch sizes requests are "
                             "padded up to (bounds the compiled-shape "
                             "set); default: powers of two up to "
                             "max_batch_size")
    parser.add_argument("--warm_buckets", type=_str2bool, default=True,
                        help="run every pad bucket once at load and "
                             "hot-swap so no live request pays cuDNN's "
                             "set-up for a new batch size")
    parser.add_argument("--ps_addrs", default="",
                        help="comma-separated TRAINING parameter-server "
                             "addresses: :lookup for tables the export "
                             "does not embed resolves against the live "
                             "PS shards through the per-model hot-row "
                             "cache (serving/embedding_service.py) — "
                             "tables larger than one server's RAM "
                             "serve from where they live (empty = "
                             "export-embedded tables only)")
    parser.add_argument("--emb_cache_mb", type=float, default=64.0,
                        help="byte budget (MiB) for the PS-backed "
                             "embedding hot-row LRU; version-keyed, "
                             "invalidated on model hot-swap and PS "
                             "restart-generation change; 0 disables "
                             "caching (every lookup pays the PS round "
                             "trip)")
    parser.add_argument("--fleet_managed", type=_str2bool,
                        default=False,
                        help="replica runs under a fleet router "
                             "(serving/router.py): local export-dir "
                             "polling is DISABLED and version changes "
                             "arrive only through the coordinator's "
                             "/fleet/prepare + /fleet/commit barrier, "
                             "so a replica rejoining mid-rollout can "
                             "never regress the fleet's committed "
                             "version off its own disk scan")
    parser.add_argument("--drain_grace_secs", type=float, default=10.0,
                        help="SIGTERM drain budget: the replica stops "
                             "admitting (503 + Connection: close), "
                             "lets in-flight batches finish up to this "
                             "long, then exits")
    parser.add_argument("--boot_version", type=int, default=-1,
                        help="pin the INITIAL load to one export "
                             "version instead of the newest complete "
                             "one on disk; the fleet autoscaler "
                             "launches replicas pinned to the "
                             "committed version so a fresh spawn "
                             "mid-canary cannot race ahead of the "
                             "fleet off its own disk scan (-1 = "
                             "newest)")


def build_serving_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.serving.server")
    add_serving_args(parser)
    return parser


def add_router_args(parser):
    """Fleet-router flags (serving/router.py): N replicated model
    servers behind one routing/hot-swap-coordination process."""
    parser.add_argument("--replicas", required=True,
                        help="comma-separated replica addresses "
                             "(host:port of serving/server.py "
                             "processes, --fleet_managed true)")
    parser.add_argument("--export_dir", default="",
                        help="versioned export base the fleet serves; "
                             "the coordinator scans it for new "
                             "complete versions and rolls them out "
                             "fleet-wide (empty = no rollout "
                             "coordination, routing only)")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--probe_interval", type=float, default=0.5,
                        help="seconds between /statz health probes of "
                             "each replica (ejected replicas are "
                             "re-probed with jittered backoff)")
    parser.add_argument("--poll_interval", type=float, default=2.0,
                        help="seconds between export-dir version scans "
                             "(rollout cadence)")
    parser.add_argument("--probe_timeout", type=float, default=2.0,
                        help="health-probe HTTP timeout; a replica "
                             "that misses one probe is ejected until "
                             "a probe succeeds again")
    parser.add_argument("--request_timeout", type=float, default=60.0,
                        help="per-forward HTTP timeout toward a "
                             "replica")
    parser.add_argument("--barrier_timeout", type=float, default=120.0,
                        help="max seconds to wait for every healthy "
                             "replica to pre-warm an incoming version "
                             "before the rollout attempt is abandoned "
                             "and retried on the next scan")
    parser.add_argument("--auto_rollout", type=_str2bool, default=True,
                        help="false: the export-dir scan only SEEDS "
                             "the committed version and heals lagging "
                             "rejoiners — rollouts arrive exclusively "
                             "through POST /fleet/rollout (the "
                             "aggregation tier is the one rollout "
                             "minter; docs/serving.md 'The online "
                             "loop')")
    # Autoscaler (serving/fleet.py FleetAutoscaler): spawn/drain
    # serving replicas off the router's OWN telemetry.
    parser.add_argument("--autoscale", type=_str2bool, default=False,
                        help="grow/shrink the replica set off router "
                             "telemetry: sustained queue-wait breach "
                             "spawns a replica (up to --max_replicas), "
                             "sustained idle drains one via the "
                             "SIGTERM graceful-drain path (down to "
                             "--min_replicas); spawned replicas boot "
                             "pinned to the committed version")
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument("--max_replicas", type=int, default=4)
    parser.add_argument("--scale_up_queue_ms", type=float, default=25.0,
                        help="mean probed queue-wait above this for "
                             "--breach_secs = scale up")
    parser.add_argument("--scale_down_queue_ms", type=float,
                        default=2.0,
                        help="queue-wait below this (and no in-flight "
                             "backlog) for --idle_secs = scale down")
    parser.add_argument("--breach_secs", type=float, default=3.0)
    parser.add_argument("--idle_secs", type=float, default=10.0)
    parser.add_argument("--autoscale_cooldown_secs", type=float,
                        default=5.0,
                        help="minimum seconds between scaling moves "
                             "(lets the previous move's effect reach "
                             "the telemetry before the next decision)")


def build_router_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.serving.router")
    add_router_args(parser)
    return parser


def build_aggregator_parser():
    """Aggregation-tier flags (aggregation/main.py): the daemon
    between trainer exports and the serving fleet (docs/serving.md
    'The online loop')."""
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.aggregation")
    parser.add_argument("--source_dir", required=True,
                        help="trainer continuous-export base "
                             "(--export_base on the worker): scanned "
                             "for new complete versions every "
                             "--poll_interval")
    parser.add_argument("--publish_dir", required=True,
                        help="fleet export base: aggregated servable "
                             "versions are published here atomically "
                             "and rolled out through the router")
    parser.add_argument("--model_name", default="")
    parser.add_argument("--window", type=int, default=4,
                        help="aggregate over the last W ingested "
                             "exports (version-deduped)")
    parser.add_argument("--agg_mode", default="ema",
                        choices=["ema", "mean", "latest"],
                        help="ema: decay-weighted toward the newest "
                             "export; mean: uniform; latest: no "
                             "aggregation (pass-through)")
    parser.add_argument("--ema_decay", type=float, default=0.5)
    parser.add_argument("--freshness_slo_secs", type=float,
                        default=10.0,
                        help="publish-freshness objective: seconds "
                             "between a trainer export landing and "
                             "its aggregate publishing; breaches are "
                             "counted (slo_misses) and the live value "
                             "rides to the router's /metrics as "
                             "elasticdl_agg_freshness_seconds")
    parser.add_argument("--publish_interval_secs", type=float,
                        default=0.0,
                        help="publish throttle: minimum seconds "
                             "between publishes (each publish costs "
                             "the fleet a rollout); 0 = publish on "
                             "every new ingest")
    parser.add_argument("--export_keep", type=int, default=8,
                        help="retention over the publish base: keep "
                             "the newest N published versions; the "
                             "fleet's committed version and anything "
                             "newer are NEVER removed (0 = keep "
                             "everything)")
    parser.add_argument("--router_addr", default="",
                        help="fleet router host:port — each publish "
                             "is driven through POST /fleet/rollout "
                             "(or the canary endpoints); empty = "
                             "publish only, something else rolls out")
    parser.add_argument("--poll_interval", type=float, default=1.0)
    parser.add_argument("--canary_fraction", type=float, default=0.0,
                        help="canary-first rollouts: slice this "
                             "fraction of the key ring onto canary "
                             "replicas, soak, then promote "
                             "barrier-clean or roll back off the "
                             "router's per-cohort error counters "
                             "(0 = plain fleet-wide rollouts)")
    parser.add_argument("--canary_soak_secs", type=float, default=15.0)
    parser.add_argument("--canary_max_error_ratio", type=float,
                        default=0.02,
                        help="canary error budget over the soak "
                             "window; above it the canary is rolled "
                             "back instead of promoted")
    parser.add_argument("--ingest_port", type=int, default=-1,
                        help="streamed-ingest HTTP endpoint (POST "
                             "/ingest takes model.frame blobs from "
                             "the trainer's ContinuousExporter — the "
                             "cross-host path needing no shared "
                             "filesystem); 0 picks a free port, -1 "
                             "disables (filesystem ingest only)")
    return parser


def parse_opt_args(opt_args):
    """Parse ``k=v;k=v`` strings; numbers become floats."""
    out = {}
    for piece in opt_args.split(";"):
        piece = piece.strip()
        if not piece:
            continue
        key, _, value = piece.partition("=")
        try:
            out[key.strip()] = float(value)
        except ValueError:
            out[key.strip()] = value.strip()
    return out


def parse_master_args(argv=None):
    return build_master_parser().parse_args(argv)


def parse_worker_args(argv=None):
    return build_worker_parser().parse_args(argv)


def parse_ps_args(argv=None):
    return build_ps_parser().parse_args(argv)


def build_arguments_from_parsed_result(args, filter_args=(), defaults=None):
    """Re-serialize a Namespace into a flag list (reference
    elasticdl_client/api.py:128-139 round-trip pattern)."""
    items = []
    for key, value in sorted(vars(args).items()):
        if key in filter_args or value is None:
            continue
        items.extend(["--" + key, str(value)])
    return items


# (flag, predicate on its value, what it selects, ROADMAP item) for every
# flag value whose path the port has not ported: none since the k8s
# backend (A19) and the multi-tenant scheduler (A20).  Master-only flags
# are absent from a worker's Namespace and read as their defaults.
_UNPORTED = ()


def not_ported(what, item):
    return NotImplementedError(
        "%s is not ported to elasticdl_tpu_torch yet (ROADMAP %s)"
        % (what, item))


def check_ported(args):
    """Raise ``NotImplementedError`` naming the ROADMAP item of the
    first flag value in ``args`` that selects an unported path."""
    for flag, selects, what, item in _UNPORTED:
        value = getattr(args, flag, None)
        if value is not None and selects(value):
            raise not_ported("--%s %s (%s)" % (flag, value, what), item)
