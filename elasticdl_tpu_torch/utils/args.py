"""Command-line flags of the port's entry points (counterpart of
``elasticdl_tpu/utils/args.py``).  Flags keep the JAX package's names
and defaults, so the master re-serializes its parsed args into worker
command lines (``build_arguments_from_parsed_result``) and a worker of
either package parses a master's flags.  A flag value that selects a
path the port has not ported yet raises ``NotImplementedError`` naming
its ROADMAP item (``check_ported``); none is silently ignored.  The
serving parser holds only the flags the port's server implements so
far."""

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


def build_serving_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.serving.server")
    parser.add_argument("--export_dir", required=True,
                        help="one export dir, or a TF-Serving-style "
                             "versioned base <base>/<N>/")
    parser.add_argument("--model_name", default=None)
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--poll_interval", type=float, default=2.0,
                        help="seconds between version re-scans of a "
                             "TF-Serving-style <base>/<N>/ export dir")
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
# flag value whose path the port has not ported.  Master-only flags are
# absent from a worker's Namespace and read as their defaults.
_UNPORTED = (
    ("distribution_strategy", lambda v: v == "ps",
     "the parameter-server strategy", "A8"),
    ("worker_backend", lambda v: v == "k8s",
     "the k8s worker backend", "A19"),
    ("jobs_spec", bool, "the multi-tenant scheduler", "A20"),
    ("export_base", bool, "continuous servable export", "A11"),
)


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
