"""Client-side dynamic sharding protocol.

Parity with elasticai_api/common/data_shard_service.py:46-212: fetch tasks
from the master, count locally-consumed records, and automatically report a
task done once its shard is fully consumed, so user training loops only call
``fetch_shard``/``report_batch_done``.
"""

import queue
import threading
import time
from collections import deque

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Sentinel: the master said "no task NOW, job not finished" (see
# fetch_task(return_wait=True)).
WAIT = object()

# Warn when this many locally-counted records sit unreported (master
# outage outlasting the RPC retry budget): the counts are safe — they
# re-flush on the next window/task boundary after reconnect — but the
# operator should know progress reporting is dark.
DEFERRED_HIGH_WATER_RECORDS = 10000


class LocalTask:
    def __init__(self, task_pb):
        self.id = task_pb.id
        self.type = task_pb.type
        self.shard = task_pb.shard
        self.size = task_pb.shard.end - task_pb.shard.start
        self.model_version = task_pb.model_version
        # Owning job under the multi-tenant scheduler (task ids are
        # only unique per job); 0 = single-job master.  Reports echo
        # it so a result lands on the dispatching job even after the
        # worker was re-assigned (docs/scheduler.md).  getattr: test
        # fakes hand in bare namespaces predating the field.
        self.job_id = getattr(task_pb, "job_id", 0)


class DataShardService:
    def __init__(self, master_client, batch_size=1, wait_poll_secs=0.5,
                 stop_check=None, telemetry_fn=None):
        """``telemetry_fn``: optional zero-arg callable returning the
        worker's live telemetry dict (Worker._telemetry_snapshot); its
        result rides every progress RPC (MasterClient.report_batch_done
        telemetry fields), so per-worker steps/s reaches the master at
        exactly the coalesced report cadence — no extra RPCs."""
        self._mc = master_client
        self._batch_size = batch_size
        self._wait_poll_secs = wait_poll_secs
        self._telemetry_fn = telemetry_fn
        self._lock = threading.Lock()
        self._pending = deque()   # tasks whose records are being consumed
        self._record_count = 0
        # Records counted locally but not yet sent to the master's
        # report_batch_done RPC — the fused driver defers per-batch
        # counts and flushes ONE RPC per window (flush is mandatory and
        # structural at task boundaries: report_task_done/failed and
        # shard auto-completion all flush first, so no progress count
        # is silently lost or double-sent).
        self._deferred_records = 0
        # Job the deferred counts belong to: the job of the most
        # recently fetched task (flushes happen at window/task
        # boundaries, before the next fetch can switch jobs).  Known
        # at-least-once edge: counts re-buffered by a failed flush and
        # re-flushed after a re-assignment land on the NEW job —
        # observability counts only, task accounting stays exact.
        # 0 = single-job master (field omitted).
        self._counts_job = 0
        self._stopped = threading.Event()
        self._stop_check = stop_check  # e.g. graceful-preemption flag
        self.exec_counters = {"batch_count": 0, "record_count": 0}

    def stop(self):
        self._stopped.set()

    def set_batch_size(self, batch_size):
        """Multi-tenant job switch: the new job may count records in a
        different default batch geometry."""
        with self._lock:
            self._batch_size = batch_size

    def _send_batch_done(self, count):
        """The progress RPC with outage protection: a failed send puts
        the counts BACK in the deferred buffer (they re-flush at the
        next window/task boundary after reconnect) instead of raising
        and stranding locally-counted records.  The buffer is one
        integer — bounded by construction — with a high-water warning
        so a long outage is visible.  Returns True when sent."""
        telemetry = None
        if self._telemetry_fn is not None:
            try:
                telemetry = self._telemetry_fn()
            except Exception as e:  # noqa: BLE001 — telemetry must
                # never fail a progress report
                logger.warning("telemetry snapshot failed: %s", e)
        kwargs = {}
        if telemetry:
            kwargs["telemetry"] = telemetry
        with self._lock:
            job = self._counts_job
        if job:
            kwargs["job_id"] = job
        try:
            # historical call shape preserved: clients (and test
            # fakes) that predate the telemetry/job piggybacks see the
            # bare positional call
            self._mc.report_batch_done(count, **kwargs)
            return True
        except Exception as e:  # noqa: BLE001 — outage outlasted retry
            with self._lock:
                self._deferred_records += count
                buffered = self._deferred_records
            logger.warning(
                "report_batch_done failed (%s); %d records re-buffered "
                "for flush after reconnect", e, buffered,
            )
            if buffered >= DEFERRED_HIGH_WATER_RECORDS:
                logger.warning(
                    "deferred progress high water: %d records counted "
                    "locally but unreported — master outage has "
                    "outlasted the RPC retry budget", buffered,
                )
            return False

    def fetch_task(self, task_type=None, wait=True, return_wait=False):
        """Fetch the next task; blocks through WAIT tasks if wait=True.

        Returns None when the master says the job is finished.  With
        ``return_wait`` a WAIT answer returns the ``WAIT`` sentinel
        instead of blocking — collective workers must not idle-spin
        inside the world (worker/worker.py leave/rejoin protocol).
        """
        while not self._stopped.is_set():
            task_pb = self._mc.get_task(task_type)
            if task_pb.id < 0:
                if task_pb.type == pb.WAIT:
                    if return_wait:
                        return WAIT
                    if wait and not (
                        self._stop_check and self._stop_check()
                    ):
                        time.sleep(self._wait_poll_secs)
                        continue
                return None
            task = LocalTask(task_pb)
            with self._lock:
                self._counts_job = task.job_id
                if task.type == pb.TRAINING:
                    # Only training tasks auto-complete via record
                    # counting; eval/predict/callback tasks are
                    # reported explicitly.
                    self._pending.append(task)
            return task

    def report_batch_done(self, batch_size=None, defer=False):
        """Count consumed records; auto-complete tasks as shards drain.

        ``defer=True`` buffers the master RPC (local accounting still
        happens immediately): the fused driver reports each batch of a
        window deferred and sends ONE coalesced ``report_batch_done``
        via ``flush_batch_done`` at the window boundary.  A shard
        draining to completion is a task boundary — it forces the flush
        regardless, so the master's progress counts are current
        whenever its task accounting changes.
        """
        done = []
        with self._lock:
            count = batch_size or self._batch_size
            self._deferred_records += count
            self._record_count += count
            self.exec_counters["batch_count"] += 1
            self.exec_counters["record_count"] += count
            while self._pending and self._record_count >= self._pending[0].size:
                task = self._pending.popleft()
                self._record_count -= task.size
                done.append((task.id, task.job_id))
            flush = self._deferred_records if (not defer or done) else 0
            if flush:
                self._deferred_records = 0
            # Snapshot inside, RPC outside: a slow/retrying master must
            # stall only this caller, not every thread entering
            # fetch_task/report_batch_done for the RPC's duration.
            counters = dict(self.exec_counters) if done else None
        if flush:
            self._send_batch_done(flush)
        for task_id, job_id in done:
            kwargs = {"job_id": job_id} if job_id else {}
            self._mc.report_task_result(task_id, exec_counters=counters,
                                        **kwargs)

    def flush_batch_done(self):
        """Send any deferred record counts in one RPC (no-op when
        nothing is buffered).  Mandatory at window boundaries, on
        preemption, and at task boundaries — report_task_done/failed
        call it structurally."""
        with self._lock:
            flush, self._deferred_records = self._deferred_records, 0
        if flush:
            self._send_batch_done(flush)

    def report_task_failed(self, task, err_message, requeue=False):
        """``requeue``: hand the task back WITHOUT consuming one of its
        retries (graceful preemption — the task isn't at fault; on a
        preemptible pool the same task could otherwise burn its whole
        retry budget on evictions and permanently fail)."""
        self.flush_batch_done()  # progress counts must precede the verdict
        with self._lock:
            try:
                was_head = self._pending and self._pending[0] is task
                self._pending.remove(task)
                # Consumption is FIFO against the head task, so only a
                # failed head can have records counted toward it — drop at
                # most its own share, never progress that belongs to other
                # pending tasks.
                if was_head:
                    self._record_count = max(
                        0, self._record_count - task.size
                    )
            except ValueError:
                pass
        kwargs = {}
        if task.job_id:
            kwargs["job_id"] = task.job_id
        self._mc.report_task_result(task.id, err_message=err_message,
                                    requeue=requeue, **kwargs)

    def report_task_done(self, task):
        self.flush_batch_done()  # progress counts must precede the verdict
        with self._lock:
            try:
                self._pending.remove(task)
            except ValueError:
                pass
            # Snapshot under the lock: the dict is mutated by
            # report_batch_done from other threads, and the gRPC client
            # iterates it during serialization.
            counters = dict(self.exec_counters)
        kwargs = {}
        if task.job_id:
            kwargs["job_id"] = task.job_id
        self._mc.report_task_result(task.id, exec_counters=counters,
                                    **kwargs)


class RecordIndexService(DataShardService):
    """Index-level sharding for map-style datasets
    (reference elasticai_api data_shard_service.py:161-212): a background
    thread drains tasks from the master into a queue of record indices, so
    a torch-style ``Dataset.__getitem__`` can consume dynamic shards
    without knowing about tasks.
    """

    def __init__(self, master_client, batch_size=1, queue_size=4096):
        super().__init__(master_client, batch_size=batch_size)
        self._index_queue = queue.Queue(maxsize=queue_size)
        self._fetcher = threading.Thread(
            target=self._fill_indices, name="record-index-fetcher",
            daemon=True,
        )
        self._exhausted = threading.Event()
        self._fetcher.start()

    def _fill_indices(self):
        try:
            while not self._stopped.is_set():
                task = self.fetch_task(task_type=pb.TRAINING, wait=True)
                if task is None:
                    break
                if task.shard.record_indices:
                    indices = list(task.shard.record_indices)
                else:
                    indices = list(
                        range(task.shard.start, task.shard.end)
                    )
                for index in indices:
                    while not self._stopped.is_set():
                        try:
                            self._index_queue.put(index, timeout=1.0)
                            break
                        except queue.Full:
                            continue
        except Exception:  # noqa: BLE001 — master gone: end of stream
            pass
        finally:
            self._exhausted.set()
            try:
                self._index_queue.put_nowait(None)
            except queue.Full:
                pass

    def fetch_record_index(self, timeout=60.0):
        """Next record index, or None when the job has no more data."""
        if self._exhausted.is_set() and self._index_queue.empty():
            return None
        index = self._index_queue.get(timeout=timeout)
        if index is None:
            self._index_queue.put(None)  # keep signaling other consumers
            return None
        return index
