"""Worker-side client to the master control plane.

Parity with elasticai_api/common/master_client.py:20-131: thin typed
wrappers over the gRPC stub, constructed from env
(``MASTER_ADDR``/``WORKER_ID``) or explicitly.

Every RPC rides out a transiently-unavailable master through the
shared retry policy (utils/retry.py): a master SIGKILLed mid-job and
relaunched with ``--journal_dir`` comes back in seconds, and clients
that would previously crash (killing the worker and burning a task
retry) now reconnect and continue.  Replay safety is the server's job:
task reports carry task ids the restarted master deduplicates against
its journal, so a retried TASK report is idempotent, never
double-counted.  Progress counters (``report_batch_done``) carry no
dedup token — a retried count whose first attempt was processed can
inflate the observability counters; task accounting stays exact
(docs/master_recovery.md, "Known at-least-once edges").
"""

import json
import os
import threading
import time
from collections import deque

import numpy as np

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.proto.rpc import MasterStub
from elasticdl_tpu_torch.utils import grpc_utils, tensor_codec
from elasticdl_tpu_torch.utils.retry import master_rpc_policy


class MasterClient:
    def __init__(self, channel, worker_id=0, worker_host=None,
                 retry=None, addr=None):
        """``retry``: a utils.retry.RetryPolicy; None installs the
        default master outage-riding policy.  Callers on a latency
        budget (the PS push path reports versions inline) pass a short
        one; ``retry_policy.timing`` is settable afterwards so the
        Worker can bind its reported Timing onto the counters.

        ``addr``: the master address, when known.  It arms channel
        REBUILD on retry: after the master is SIGKILLed, the live
        channel's subchannel can wedge (stale connect backoff /
        poisoned fd never reaching the restarted listener), so each
        retry reconnects on a fresh channel — the first retry after
        the master is back succeeds immediately."""
        self._channel = channel
        self._stub = MasterStub(channel)
        self._addr = addr
        # One client is shared across threads (record-index fetcher,
        # deferred report flush, the main task loop), so rebuilds are
        # serialized and generation-counted: the first thread to notice
        # the outage rebuilds, later threads adopt its fresh stub.
        self._refresh_lock = threading.Lock()
        self._gen = 0
        # Retired channels are parked, NOT closed: channel.close()
        # terminates every in-flight RPC on it with CANCELLED — a code
        # the retry policy rightly refuses to retry — so another
        # thread's concurrent call would crash in exactly the outage
        # the retry machinery rides out.  Entries are (channel,
        # retired_at) and a channel is only closed once it has been
        # parked longer than _RETIRE_AGE_SECS — a count bound alone
        # is not safe: one fast-failing retry loop can cycle the
        # deque in seconds while a blackholed peer still holds
        # another thread's RPC in flight on the oldest channel.
        self._retired = deque()
        self._last_rebuild = 0.0
        self.retry_policy = retry if retry is not None else (
            master_rpc_policy()
        )
        self.worker_id = worker_id
        self.worker_host = worker_host or "worker-%d" % worker_id
        # Multi-tenant scheduler handshake (docs/scheduler.md): the
        # master's get_task response names the job this worker is
        # assigned to (0 = single-job master) and, when the assignment
        # changed, carries the job's worker config.  Subsequent RPCs
        # echo job_id so reports route to the owning job even across a
        # re-assignment.  Written only on the task-loop thread (the
        # one that calls get_task).
        self.job_id = 0
        self.job_config = None

    @classmethod
    def from_env(cls):
        addr = os.environ["MASTER_ADDR"]
        worker_id = int(os.environ.get("WORKER_ID", 0))
        channel = grpc_utils.build_channel(addr)
        grpc_utils.connect_to_master(channel, addr)
        return cls(channel, worker_id=worker_id, addr=addr)

    # A parked channel may only be closed after this long: older than
    # any plausible in-flight RPC on it (the outage-riding deadline
    # budget is 120 s by default).
    _RETIRE_AGE_SECS = 150.0
    # Floor between rebuilds: one wedged channel needs ONE fresh
    # replacement, not one per backoff step of every retrying thread —
    # without a floor, a single fast-failing retry loop mints channels
    # faster than parked ones can age out.
    _REBUILD_INTERVAL_SECS = 2.0

    def _refresh_stub(self, method_name, state):
        """Rebuild the channel (see ``addr`` in __init__) and return
        the fresh stub method for the retry loop; None (no rebuild)
        when the address is unknown.  ``state['gen']`` is the
        generation this caller last saw: if another thread already
        rebuilt past it, no second rebuild — adopt the fresh stub."""
        if self._addr is None:
            return None
        with self._refresh_lock:
            now = time.monotonic()
            if (
                state["gen"] == self._gen
                and now - self._last_rebuild >= self._REBUILD_INTERVAL_SECS
            ):
                self._retired.append((self._channel, now))
                while self._retired and (
                    now - self._retired[0][1] > self._RETIRE_AGE_SECS
                ):
                    old, _ = self._retired.popleft()
                    try:
                        old.close()
                    except Exception:  # noqa: BLE001 — already broken
                        pass
                self._channel = grpc_utils.build_channel(self._addr)
                self._stub = MasterStub(self._channel)
                self._gen += 1
                self._last_rebuild = now
            state["gen"] = self._gen
            return getattr(self._stub, method_name)

    def _call(self, rpc_fn, request, method_name, state):
        return self.retry_policy.call(
            rpc_fn, request, description=method_name,
            refresh=lambda: self._refresh_stub(method_name, state),
        )

    def get_task(self, task_type=None):
        req = pb.GetTaskRequest(worker_id=self.worker_id,
                                job_id=self.job_id)
        if task_type is not None:
            req.task_type = task_type
        # Snapshot the (stub, generation) pair coherently under the
        # refresh lock — a racing rebuild can't hand this call a torn
        # (old stub, new gen) pair — then RPC outside it.
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        res = self._call(stub.get_task, req, "get_task", state)
        if res.job_id and res.job_id != self.job_id:
            # Re-assignment handshake: adopt the new job identity; the
            # Worker loop reads job_config and rebuilds its pipeline
            # before processing the first task of the new job.
            self.job_id = res.job_id
            if res.job_config:
                self.job_config = json.loads(res.job_config)
        return res.task

    def report_task_result(self, task_id, err_message="", exec_counters=None,
                           requeue=False, job_id=None):
        """``job_id``: the OWNING job of ``task_id`` (task ids are only
        unique per job under the multi-tenant scheduler); defaults to
        the current assignment — callers that report after a
        re-assignment pass the task's job explicitly."""
        req = pb.ReportTaskResultRequest(
            task_id=task_id, err_message=err_message, requeue=requeue,
            job_id=self.job_id if job_id is None else job_id,
        )
        for k, v in (exec_counters or {}).items():
            req.exec_counters[k] = int(v)
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(
            stub.report_task_result, req, "report_task_result", state
        )

    def report_batch_done(self, record_count, telemetry=None,
                          job_id=None):
        """``telemetry``: optional dict of live training health
        piggybacked on the progress report (docs/observability.md) —
        keys matching the ReportBatchDoneRequest telemetry fields
        (steps_per_sec, sync_fraction, push_staleness, window_size,
        steps_done); unknown keys are ignored.  ``job_id``: the job
        these records/telemetry belong to (defaults to the current
        assignment) — keys the master's per-job aggregate so shared-
        pool jobs never collide."""
        req = pb.ReportBatchDoneRequest(
            worker_id=self.worker_id, record_count=record_count,
            job_id=self.job_id if job_id is None else job_id,
        )
        for field in ("steps_per_sec", "sync_fraction",
                      "push_staleness", "window_size"):
            value = (telemetry or {}).get(field)
            if value is not None:
                setattr(req, field, float(value))
        steps_done = (telemetry or {}).get("steps_done")
        if steps_done is not None:
            req.steps_done = int(steps_done)
        hist_delta = (telemetry or {}).get("hist_delta")
        if hist_delta:
            # Sparse step-time histogram delta (utils/hist.py): the
            # master merges these exactly into per-worker/per-job
            # distributions — the percentile-plane piggyback.
            req.hist_delta = hist_delta
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(stub.report_batch_done, req, "report_batch_done", state)

    def get_comm_rank(self):
        req = pb.GetCommRankRequest(worker_host=self.worker_host,
                                    job_id=self.job_id)
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        return self._call(stub.get_comm_rank, req, "get_comm_rank", state)

    def report_train_loop_status(self, status, job_id=None):
        """``job_id``: which job's world to join/leave — a drained
        worker LOOP_ENDs its OLD job during the re-assignment
        handshake; defaults to the current assignment."""
        req = pb.ReportTrainLoopStatusRequest(
            worker_host=self.worker_host, status=status,
            job_id=self.job_id if job_id is None else job_id,
        )
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(
            stub.report_train_loop_status, req,
            "report_train_loop_status", state,
        )

    def report_evaluation_metrics(self, model_outputs, labels,
                                  model_version=-1):
        req = pb.ReportEvaluationMetricsRequest(
            worker_id=self.worker_id, model_version=model_version,
            job_id=self.job_id,
        )
        if isinstance(model_outputs, dict):
            for name, arr in model_outputs.items():
                tensor_codec.ndarray_to_pb(
                    np.asarray(arr), out=req.model_outputs[name]
                )
        else:
            tensor_codec.ndarray_to_pb(
                np.asarray(model_outputs), out=req.model_outputs["output"]
            )
        tensor_codec.ndarray_to_pb(np.asarray(labels), out=req.labels)
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(
            stub.report_evaluation_metrics, req,
            "report_evaluation_metrics", state,
        )

    def report_version(self, version, ps_id=None, generation=0,
                       durable_version=0):
        """``ps_id`` (+ generation/durable_version) marks this as a PS
        shard's report: the master tracks per-shard recovery state and
        derives the coordinated-checkpoint commit mark from the
        cross-shard min of ``durable_version`` (docs/ps_recovery.md).
        Workers report plain versions and leave the PS fields unset."""
        req = pb.ReportVersionRequest(model_version=version,
                                      job_id=self.job_id)
        if ps_id is not None:
            req.is_ps = True
            req.ps_id = int(ps_id)
            req.generation = int(generation)
            req.durable_version = int(durable_version)
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(stub.report_version, req, "report_version", state)

    def report_training_params(self, **kwargs):
        req = pb.ReportTrainingParamsRequest(**kwargs)
        with self._refresh_lock:
            stub = self._stub
            state = {"gen": self._gen}
        self._call(
            stub.report_training_params, req,
            "report_training_params", state,
        )
