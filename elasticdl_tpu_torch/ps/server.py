"""Parameter-server process (parity:
elasticdl/python/ps/parameter_server.py:35-161,
go/cmd/elasticdl_ps/main.go:27-74).

Every start establishes a monotone restart GENERATION (persisted beside
the checkpoints, and/or hinted by the launcher's ``--generation``); the
servicer stamps it on every data-plane response so workers detect a
relaunch and reconcile instead of training against a silently
rolled-back shard (docs/ps_recovery.md)."""

import os
import signal
import threading

from elasticdl_tpu_torch.proto import rpc
from elasticdl_tpu_torch.ps.optimizer import create_optimizer
from elasticdl_tpu_torch.ps.parameters import Parameters
from elasticdl_tpu_torch.ps.servicer import PserverServicer
from elasticdl_tpu_torch.utils import grpc_utils, tracing
from elasticdl_tpu_torch.utils.args import parse_ps_args
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def establish_generation(checkpoint_dir, ps_id, hint=0):
    """Monotone restart generation for this shard, bumped on EVERY
    start.  With a checkpoint dir the counter persists in
    ``<dir>/generation-<ps_id>`` (written durably BEFORE the shard
    serves, so no response can carry a generation a crash could
    reissue); the launcher's ``hint`` (PSManager passes its per-shard
    launch count) can only move it forward.  Without either there is
    nothing to fence against and the generation is a constant 1 —
    fencing needs a persisted counter or a counting launcher."""
    persisted = 0
    path = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "generation-%d" % ps_id)
        try:
            with open(path, "r") as f:
                persisted = int(f.read().strip() or 0)
        except (OSError, ValueError):
            persisted = 0
    generation = max(persisted + 1, int(hint or 0), 1)
    if path is not None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("%d\n" % generation)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the DIRECTORY too: the rename itself must be durable
        # before this generation stamps any response, or a power cut
        # could resurrect the old counter and let a future start
        # reissue this incarnation's generation.
        dirfd = os.open(checkpoint_dir, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    return generation


class ParameterServer:
    def __init__(self, args, master_client=None):
        self.args = args
        self._master_client = master_client
        self.parameters = Parameters()
        self.optimizer = create_optimizer(args.opt_type, args.opt_args)
        self.generation = establish_generation(
            args.checkpoint_dir or args.checkpoint_dir_for_init,
            args.ps_id, hint=getattr(args, "generation", 0),
        )
        # Identity now carries the incarnation: "[ps-0@g2]" log lines
        # and generation-stamped flight-recorder events make a relaunch
        # attributable at a glance in interleaved drill logs.
        tracing.configure_identity("ps", rank=args.ps_id,
                                   generation=self.generation)
        tracing.event("ps.generation_established",
                      generation=self.generation)
        logger.info("PS shard %d starting as generation %d",
                    args.ps_id, self.generation)
        saver = None
        if args.checkpoint_dir:
            saver = CheckpointSaver(
                args.checkpoint_dir, keep_max=args.keep_checkpoint_max
            )
        self.servicer = PserverServicer(
            self.parameters,
            self.optimizer,
            ps_id=args.ps_id,
            num_ps=args.num_ps,
            use_async=args.use_async,
            grads_to_wait=args.grads_to_wait,
            sync_version_tolerance=args.sync_version_tolerance,
            lr_staleness_modulation=args.lr_staleness_modulation,
            checkpoint_saver=saver,
            checkpoint_steps=args.checkpoint_steps,
            evaluation_steps=args.evaluation_steps,
            master_client=master_client,
            generation=self.generation,
        )
        self._server = None
        self.port = None
        self._done = threading.Event()
        if args.checkpoint_dir_for_init:
            self._restore(args.checkpoint_dir_for_init)

    def _restore(self, ckpt_dir):
        """Restore this shard from the newest COMMITTED (cross-shard
        consistent) checkpoint version, re-hash-routing if the shard
        count changed (reference go/pkg/ps/checkpoint.go:98-133;
        barrier semantics: docs/ps_recovery.md).  A shard with no
        committed checkpoint re-enters the uninitialized state and the
        workers' push-to-init path re-seeds it mid-run."""
        saver = CheckpointSaver(ckpt_dir)
        try:
            dense, embeddings, version = saver.load_shard(
                None, self.args.ps_id, self.args.num_ps
            )
        except FileNotFoundError as e:
            logger.warning("no checkpoint to restore in %s (%s); "
                           "awaiting worker push-to-init", ckpt_dir, e)
            return
        # Rollback truncation: files this shard wrote AFTER the version
        # being restored belong to the dead incarnation's abandoned
        # timeline — left in place one could later complete a label into
        # a fake "committed" set that mixes timelines.
        saver.truncate_shard_after(
            version, self.args.ps_id, self.args.num_ps
        )
        slot_payload = {
            k[len("optslot/"):]: dense.pop(k)
            for k in [k for k in dense if k.startswith("optslot/")]
        }
        if slot_payload:
            self.optimizer.restore_slots_from_payload(slot_payload)
        infos = [
            {"name": n, "dim": v[1].shape[1]}
            for n, v in embeddings.items()
            if not n.startswith("slot:") and len(v[1])
        ]
        self.parameters.restore_from_checkpoint_payload(
            dense, embeddings, infos,
            slot_names=self.optimizer.slot_names,
        )
        self.parameters.version = version
        self.servicer.seed_durable_version(version)
        logger.info("restored PS shard %d from version %d",
                    self.args.ps_id, version)

    def prepare(self):
        interceptors = []
        if getattr(self.args, "rpc_delay_ms", 0) > 0:
            # Bench rigs run worker and PS on one host; this emulates
            # the cross-host wire latency the overlap path is built
            # to hide (see bench_ps_wire.py).
            interceptors.append(grpc_utils.RpcDelayInterceptor(
                self.args.rpc_delay_ms / 1000.0
            ))
        if getattr(self.args, "rpc_fault_spec", ""):
            # Deterministic fault drills (docs/master_recovery.md):
            # script "every Nth push fails" / "shard dark for 5 s"
            # reproducibly against the worker retry paths.
            logger.warning(
                "PS RPC fault injection armed: %s",
                self.args.rpc_fault_spec,
            )
            interceptors.append(grpc_utils.FaultInjectionInterceptor(
                self.args.rpc_fault_spec
            ))
        interceptors = interceptors or None
        self._server = grpc_utils.build_server(
            max_workers=64, interceptors=interceptors
        )
        rpc.add_pserver_servicer(self.servicer, self._server)
        self.port = self._server.add_insecure_port(
            "[::]:%d" % self.args.port
        )
        self._server.start()
        logger.info("PS %d/%d listening on port %d",
                    self.args.ps_id, self.args.num_ps, self.port)
        if getattr(self.args, "status_port", -1) >= 0:
            from elasticdl_tpu_torch.master.status_server import (
                HttpStatusServer,
            )
            from elasticdl_tpu_torch.utils.prom import ps_to_prometheus
            from elasticdl_tpu_torch.utils.slo import slo_section

            def collect():
                status = {
                    "ps_id": self.args.ps_id,
                    "num_ps": self.args.num_ps,
                    "version": self.parameters.version,
                    "generation": self.generation,
                    "durable_version": self.servicer.durable_version,
                    "initialized": self.parameters.initialized,
                    "counters": dict(self.servicer.counters),
                    # Per-encoding data-plane byte accounting (frame
                    # vs pb payload + decode-copy bytes) — the
                    # frame-wire bench's server-side artifact.
                    "wire": dict(self.servicer.wire_counters),
                    # Push/pull handle-time histograms: rendered
                    # natively by utils/prom.ps_to_prometheus (the one
                    # renderer home — the inline renderer that used to
                    # live here moved there with them).
                    "hists": self.servicer.timing.histograms(),
                }
                slo = slo_section()
                if slo is not None:
                    status["slo"] = slo
                return status

            self._status_server = HttpStatusServer(collect,
                                                   ps_to_prometheus,
                                                   port=self.args.
                                                   status_port)
            self._status_server.start()
        if self._master_client is not None:
            # Self-terminate when the master goes away (reference: the Go
            # PS polls the master pod every 30s, k8s_client.go:42-60) so
            # orphaned PS shards never outlive their job.
            threading.Thread(
                target=self._watch_master, name="master-watch",
                daemon=True,
            ).start()

    def _watch_master(self, poll_secs=30, max_misses=3):
        misses = 0
        while not self._done.is_set() and misses < max_misses:
            self._done.wait(poll_secs)
            if self._done.is_set():
                return
            try:
                self._master_client.get_comm_rank()
                misses = 0
            except Exception:  # noqa: BLE001
                misses += 1
        if misses >= max_misses:
            logger.info("master unreachable; PS shutting down")
            self.stop()

    def run(self):
        self._done.wait()
        self.stop()

    def stop(self, checkpoint=False):
        if checkpoint:
            # Graceful preemption (SIGTERM): persist the shard's
            # CURRENT state — params, embedding tables, optimizer
            # slots — so the relaunched shard resumes this exact
            # version instead of the last periodic save.
            try:
                self.servicer.checkpoint_now()
            except Exception as e:  # noqa: BLE001 — best effort under
                # a kill deadline
                logger.error("preemption checkpoint failed: %s", e)
        self._done.set()
        if getattr(self, "_status_server", None) is not None:
            self._status_server.stop()
            self._status_server = None
        if self._server is not None:
            self._server.stop(grace=1)
            self._server = None


def main(argv=None):
    args = parse_ps_args(argv)
    master_client = None
    if args.master_addr:
        from elasticdl_tpu_torch.utils.retry import RetryPolicy
        from elasticdl_tpu_torch.worker.master_client import MasterClient

        channel = grpc_utils.build_channel(args.master_addr)
        # SHORT budget: report_version runs inline on the gradient-push
        # path (after the update lock is released but before the push
        # RPC returns) — a master mid-restart should be ridden out for
        # a few seconds, never stall pushes for the full worker-side
        # outage budget.  _report_version swallows the final failure.
        master_client = MasterClient(
            channel, worker_id=-1, addr=args.master_addr,
            retry=RetryPolicy(
                name="ps_master_rpc", max_attempts=4,
                deadline_secs=5.0, base_delay_secs=0.2,
                max_delay_secs=1.0,
            ),
        )
    ps = ParameterServer(args, master_client=master_client)
    ps.prepare()
    # Operator SLO rules from the environment (ELASTICDL_SLO_SPEC,
    # e.g. "p99(ps.push_handle) < 0.02") resolve against the
    # servicer's handle-time histograms.
    from elasticdl_tpu_torch.utils import slo as slo_mod

    slo_mod.default_watchdog().bind_timing(ps.servicer.timing)
    slo_mod.default_watchdog().arm_from_env()
    signal.signal(signal.SIGTERM, lambda *a: ps.stop(checkpoint=True))
    # AFTER the graceful-checkpoint hook: SIGTERM dumps the flight
    # recorder first, then runs the checkpoint-and-stop chain.
    tracing.arm_crash_dump()
    ps.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
