"""Dynamic data sharding — the heart of elasticity.

The TaskManager partitions the dataset into shards and hands them out as
tasks; any task owned by a dead worker goes back on the todo queue, which is
what lets workers die and join freely.  Semantics match the reference's
task manager (elasticdl/python/master/task_manager.py:35-616): todo/doing
queues, <=3 retries per task, per-epoch regeneration with optional shuffle,
a timeout watchdog, version-triggered evaluation tasks and a deferred
train-end callback task.
"""

import random
import threading
import time
from collections import deque, namedtuple

from elasticdl_tpu_torch.master.journal import journal_events
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MAX_TASK_RETRIES = 3
TASK_TIMEOUT_THRESHOLD_SECS = 300

# Result of TaskManager.report: task is None for unknown ids;
# permanent_failure marks a task that exhausted its retries.
ReportResult = namedtuple("ReportResult", ["ok", "task", "permanent_failure"])


class Shard:
    __slots__ = ("name", "start", "end", "record_indices")

    def __init__(self, name, start, end, record_indices=None):
        self.name = name
        self.start = start
        self.end = end
        self.record_indices = record_indices or []

    @property
    def size(self):
        return self.end - self.start

    def to_pb(self, out=None):
        s = out if out is not None else pb.ShardPB()
        s.name = self.name
        s.start = self.start
        s.end = self.end
        del s.record_indices[:]
        s.record_indices.extend(self.record_indices)
        return s


class Task:
    __slots__ = ("id", "shard", "type", "model_version", "retry_count")

    def __init__(self, task_id, shard, task_type, model_version=-1):
        self.id = task_id
        self.shard = shard
        self.type = task_type
        self.model_version = model_version
        self.retry_count = 0

    def to_pb(self, out=None):
        t = out if out is not None else pb.TaskPB()
        t.id = self.id
        t.type = self.type
        self.shard.to_pb(out=t.shard)
        t.model_version = self.model_version
        return t


def wait_task_pb():
    return pb.TaskPB(id=-1, type=pb.WAIT)


class TaskManager:
    """Thread-safe todo/doing task queues over dataset shards."""

    def __init__(
        self,
        training_shards=None,
        evaluation_shards=None,
        prediction_shards=None,
        records_per_task=None,
        num_epochs=1,
        shuffle=False,
        shuffle_shards=False,
        max_task_retries=MAX_TASK_RETRIES,
        task_timeout_secs=TASK_TIMEOUT_THRESHOLD_SECS,
        seed=None,
    ):
        self._lock = threading.Lock()
        self._training_shards = list(training_shards or [])
        self._evaluation_shards = list(evaluation_shards or [])
        self._prediction_shards = list(prediction_shards or [])
        self._records_per_task = records_per_task
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._shuffle_shards = shuffle_shards
        self._max_task_retries = max_task_retries
        self._task_timeout_secs = task_timeout_secs
        self._rng = random.Random(seed)

        self._todo = deque()
        # task_id -> (worker_id, task, start_time)
        self._doing = {}
        self._task_id = 0
        self._epoch = 0
        # Crash-restart recovery (master/journal.py): lifecycle events
        # stream to the journal (appended OUTSIDE self._lock — EL006
        # proves it); _done_ids lets a restarted master deduplicate a
        # worker re-reporting a task the pre-crash master already
        # counted, so nothing is double-counted across a restart.
        self._journal = None
        self._done_ids = set()
        self._train_end_callback_pending = False
        self._train_end_callback_done = False
        self._max_task_completed_time = 0.0
        self.completed_counts = {t: 0 for t in
                                 (pb.TRAINING, pb.EVALUATION, pb.PREDICTION,
                                  pb.TRAIN_END_CALLBACK)}
        self.failed_counts = dict(self.completed_counts)
        self._worker_timeout_callbacks = []
        self._watchdog = None
        self._stopped = threading.Event()

        if self._training_shards:
            logger.info(
                "TaskManager: %d training shards, %d epochs",
                len(self._training_shards), num_epochs,
            )
            self._create_training_tasks_locked()
        elif self._prediction_shards:
            self._create_tasks_locked(self._prediction_shards, pb.PREDICTION)

    # -- task creation ------------------------------------------------------

    def _split(self, shards):
        """Split (name, start, end) ranges into records_per_task chunks."""
        out = []
        for name, start, end in shards:
            if not self._records_per_task:
                out.append(Shard(name, start, end))
                continue
            pos = start
            while pos < end:
                chunk_end = min(pos + self._records_per_task, end)
                out.append(Shard(name, pos, chunk_end))
                pos = chunk_end
        return out

    @staticmethod
    def _task_event(task):
        event = {
            "ev": "task", "id": task.id, "type": task.type,
            "name": task.shard.name, "start": task.shard.start,
            "end": task.shard.end, "mv": task.model_version,
        }
        if task.shard.record_indices:
            event["idx"] = list(task.shard.record_indices)
        return event

    def _create_tasks_locked(self, shards, task_type, model_version=-1,
                             events=None):
        pieces = self._split(shards)
        if task_type == pb.TRAINING and self._shuffle_shards:
            self._rng.shuffle(pieces)
        if task_type == pb.TRAINING and self._shuffle:
            for piece in pieces:
                indices = list(range(piece.start, piece.end))
                self._rng.shuffle(indices)
                piece.record_indices = indices
        tasks = []
        for piece in pieces:
            self._task_id += 1
            tasks.append(Task(self._task_id, piece, task_type, model_version))
        self._todo.extend(tasks)
        if events is not None:
            events.extend(self._task_event(t) for t in tasks)
        return tasks

    def _create_training_tasks_locked(self, events=None):
        self._create_tasks_locked(
            self._training_shards, pb.TRAINING, events=events
        )

    def skip_records(self, num_records):
        """Drop already-trained records after a checkpoint resume
        (reference: master recovers completed_steps from the checkpoint
        version, task_manager.py:208-221).  Whole tasks are dropped while
        their full span fits in num_records; the remainder trims the next
        task's front."""
        events = []
        with self._lock:
            skipped = 0
            while self._todo and num_records - skipped > 0:
                task = self._todo[0]
                size = task.shard.size
                if size <= num_records - skipped:
                    self._todo.popleft()
                    skipped += size
                    self.completed_counts[task.type] += 1
                    self._done_ids.add(task.id)
                    events.append({"ev": "done", "id": task.id})
                else:
                    trim = num_records - skipped
                    task.shard.start += trim
                    if task.shard.record_indices:
                        task.shard.record_indices = (
                            task.shard.record_indices[trim:]
                        )
                    skipped += trim
                    events.append(
                        {"ev": "trim", "id": task.id,
                         "start": task.shard.start}
                    )
            logger.info("resume: skipped %d records", skipped)
        journal_events(self._journal, events)
        return skipped

    def create_evaluation_tasks(self, model_version):
        """Version-triggered eval job (reference task_manager create_evaluation_tasks)."""
        events = []
        with self._lock:
            tasks = self._create_tasks_locked(
                self._evaluation_shards, pb.EVALUATION, model_version,
                events=events,
            )
            # Evaluation interleaves ahead of remaining training tasks.
            for _ in tasks:
                self._todo.rotate(1)
            n = len(tasks)
        journal_events(self._journal, events)
        return n

    def set_train_end_callback_task(self):
        with self._lock:
            self._train_end_callback_pending = True
        journal_events(self._journal, [{"ev": "cb"}])

    # -- dispatch -----------------------------------------------------------

    def get(self, worker_id):
        """Pop the next task for a worker; None when nothing is available."""
        events = []
        with self._lock:
            task = self._get_locked(worker_id, events)
        journal_events(self._journal, events)
        return task

    def _get_locked(self, worker_id, events):
        if not self._todo and not self._doing:
            if self._epoch < self._num_epochs - 1 and self._training_shards:
                self._epoch += 1
                logger.info("starting epoch %d", self._epoch)
                events.append({"ev": "epoch", "n": self._epoch})
                self._create_training_tasks_locked(events=events)
            elif (
                self._train_end_callback_pending
                and not self._train_end_callback_done
                and self._finished_training_locked()
            ):
                self._train_end_callback_done = True
                self._task_id += 1
                task = Task(
                    self._task_id, Shard("", 0, 0), pb.TRAIN_END_CALLBACK
                )
                self._doing[task.id] = (worker_id, task, time.time())
                events.append(self._task_event(task))
                events.append(
                    {"ev": "dispatch", "id": task.id, "w": worker_id}
                )
                return task
        if not self._todo:
            return None
        task = self._todo.popleft()
        self._doing[task.id] = (worker_id, task, time.time())
        events.append({"ev": "dispatch", "id": task.id, "w": worker_id})
        return task

    def report(self, task_id, success, err_message="", requeue=False):
        """Worker reports a task result; failed tasks are retried <=N times.

        ``requeue=True`` (an explicit proto field, set by observers like
        the job monitor) puts the task back WITHOUT consuming a retry
        and without counting completion — the task was only peeked,
        never worked.

        Replay safety across a master restart: a report for a task the
        journaled master already completed is deduplicated (idempotent
        success), and a success report for a task sitting in the todo
        queue (requeued on restart while its worker rode out the
        outage) completes it from the queue — the task is neither
        double-counted nor re-trained.

        Returns a ReportResult.
        """
        events = []
        with self._lock:
            result = self._report_locked(
                task_id, success, err_message, requeue, events
            )
        journal_events(self._journal, events)
        # Mirror the task-lifecycle journal events into the flight
        # recorder (same outside-the-lock discipline): a task put BACK
        # in the queue — retry or requeue — is the elastic incident a
        # trace wants, and it lands in the reporting worker's trace
        # (servicer records the completion-side breadcrumbs).
        for ev in events:
            if ev.get("ev") == "requeue":
                tracing.event("task.requeue", task=ev.get("id"))
        return result

    def _report_locked(self, task_id, success, err_message, requeue,
                       events):
        entry = self._doing.pop(task_id, None)
        if entry is None:
            return self._report_undispatched_locked(
                task_id, success, err_message, requeue, events
            )
        worker_id, task, start_time = entry
        if requeue:
            logger.info("task %d handed back by observer", task_id)
            self._todo.appendleft(task)
            events.append({"ev": "requeue", "id": task_id})
            return ReportResult(False, task, False)
        if success:
            elapsed = time.time() - start_time
            self._max_task_completed_time = max(
                self._max_task_completed_time, elapsed
            )
            return self._complete_locked(task, events)
        return self._fail_locked(task, err_message, events)

    def _report_undispatched_locked(self, task_id, success, err_message,
                                    requeue, events):
        """A report for a task not in doing: either a duplicate of an
        already-counted completion (master restarted after journaling
        it) or a task the restart requeued while its worker kept
        working through the outage."""
        if task_id in self._done_ids:
            logger.info(
                "task %d already completed; duplicate report "
                "deduplicated", task_id,
            )
            return ReportResult(True, None, False)
        task = next(
            (t for t in self._todo if t.id == task_id), None
        )
        if task is None:
            logger.warning("report for unknown task %d", task_id)
            return ReportResult(False, None, False)
        if requeue:
            # Observer hand-back (e.g. graceful preemption) racing the
            # restart's own requeue: the task is already back in todo —
            # leave it there, and honor the no-retry-burned contract.
            logger.info(
                "task %d handed back by observer; already requeued",
                task_id,
            )
            return ReportResult(False, task, False)
        if success:
            self._todo.remove(task)
            logger.info(
                "task %d completed by a worker that rode out a master "
                "restart; accepting from the requeued state", task_id,
            )
            return self._complete_locked(task, events)
        # Failure report for a task sitting in todo: it is ALREADY
        # queued for re-dispatch, so requeue is the right outcome and
        # it has happened.  Do not burn a retry — under the client's
        # RPC retry a processed-failure-with-lost-response is reported
        # twice, and charging both would permanently fail a task after
        # half its real budget.  A genuinely poisoned task still burns
        # retries normally once re-dispatched (it fails from _doing).
        logger.info(
            "task %d failure reported (%s) while already requeued; "
            "keeping queued without charging a retry",
            task_id, err_message or "unspecified",
        )
        return ReportResult(False, task, False)

    def _complete_locked(self, task, events):
        self.completed_counts[task.type] += 1
        self._done_ids.add(task.id)
        events.append({"ev": "done", "id": task.id})
        return ReportResult(True, task, False)

    def _fail_locked(self, task, err_message, events):
        task.retry_count += 1
        if task.retry_count <= self._max_task_retries:
            logger.info(
                "task %d failed (%s), retry %d/%d",
                task.id, err_message, task.retry_count,
                self._max_task_retries,
            )
            self._todo.appendleft(task)
            events.append(
                {"ev": "fail", "id": task.id, "perm": False,
                 "retries": task.retry_count}
            )
            return ReportResult(False, task, False)
        logger.error(
            "task %d permanently failed: %s", task.id, err_message
        )
        self.failed_counts[task.type] += 1
        events.append(
            {"ev": "fail", "id": task.id, "perm": True,
             "retries": task.retry_count}
        )
        return ReportResult(False, task, True)

    # -- crash-restart recovery (master/journal.py) -------------------------

    def attach_journal(self, journal, bootstrap=True):
        """Start streaming lifecycle events to ``journal``.

        ``bootstrap=True`` (fresh start) journals the current queue so
        replay can rebuild it; a restarted master attaches with
        ``bootstrap=False`` — its state CAME from the journal, and
        re-journaling it would duplicate every task record."""
        events = []
        if bootstrap:
            with self._lock:
                if self._epoch:
                    events.append({"ev": "epoch", "n": self._epoch})
                events.extend(self._task_event(t) for t in self._todo)
                if self._train_end_callback_pending:
                    events.append({"ev": "cb"})
        self._journal = journal
        journal_events(journal, events)

    def restore_from_journal(self, state):
        """Rebuild the queues from a replayed JournalState: in-flight
        tasks are requeued at the front (their worker may be mid-task,
        riding out the outage — `report` accepts their result from the
        queue), completed/failed counts and the epoch resume exactly,
        and already-completed ids arm the duplicate-report dedup."""
        with self._lock:
            self._todo.clear()
            self._doing.clear()
            dropped_eval = 0
            for rec in state.pending_tasks():
                if rec["type"] == pb.EVALUATION:
                    # EvaluationService state (the job's metric
                    # accumulators, completion count) is NOT journaled
                    # — declared out of recovery scope — so a restart
                    # has no eval job to fold these into: completions
                    # would be dropped or, worse, folded into the NEXT
                    # version's job.  Drop them loudly; evaluation
                    # re-arms cleanly at the next version report.
                    dropped_eval += 1
                    continue
                shard = Shard(
                    rec.get("name", ""), rec["start"], rec["end"],
                    list(rec.get("idx") or []),
                )
                task = Task(
                    rec["id"], shard, rec["type"], rec.get("mv", -1)
                )
                task.retry_count = state.retries.get(rec["id"], 0)
                self._todo.append(task)
            if dropped_eval:
                logger.warning(
                    "master restart: %d pending EVALUATION task(s) "
                    "dropped (evaluation-service state is not "
                    "recovered; the next version report re-creates "
                    "the eval job)", dropped_eval,
                )
            self._task_id = max(self._task_id, state.max_task_id)
            self._epoch = max(self._epoch, state.epoch)
            for task_type, n in state.completed_counts.items():
                self.completed_counts[task_type] = n
            for task_type, n in state.failed_counts.items():
                self.failed_counts[task_type] = n
            self._train_end_callback_pending = (
                self._train_end_callback_pending
                or state.train_end_pending
            )
            self._train_end_callback_done = state.train_end_created
            self._done_ids = set(state.done_ids)
            restored = {
                "todo": len(self._todo),
                "completed": dict(self.completed_counts),
                "failed": dict(self.failed_counts),
                "epoch": self._epoch,
                "next_task_id": self._task_id + 1,
            }
        logger.warning(
            "master restart: task state restored from journal "
            "(in-flight tasks requeued): %s", restored,
        )

    def recover_tasks(self, worker_id):
        """Re-queue every task a dead worker was holding (elasticity path)."""
        with self._lock:
            owned = [
                tid for tid, (wid, _, _) in self._doing.items()
                if wid == worker_id
            ]
        for tid in owned:
            self.report(tid, False, err_message="worker %s died" % worker_id)

    def requeue_worker_tasks(self, worker_id):
        """Scheduler drain (docs/scheduler.md): hand back every task the
        worker holds WITHOUT consuming retries — an elastic shrink is
        not the task's fault, exactly like the observer hand-back on
        graceful preemption.  The worker may still be mid-task, riding
        out the re-assignment: when it later reports the requeued task,
        ``report`` accepts the result from the todo queue (the same
        replay-safe path a master restart uses).  Returns the ids."""
        with self._lock:
            owned = [
                tid for tid, (wid, _, _) in self._doing.items()
                if wid == worker_id
            ]
        for tid in owned:
            self.report(
                tid, False,
                err_message="worker %s drained by scheduler" % worker_id,
                requeue=True,
            )
        return owned

    # -- progress -----------------------------------------------------------

    def _finished_training_locked(self):
        done_epochs = self._epoch >= self._num_epochs - 1
        return done_epochs and not self._todo and not any(
            t.type == pb.TRAINING for _, t, _ in self._doing.values()
        )

    def finished_training(self):
        with self._lock:
            return self._finished_training_locked()

    def finished(self):
        with self._lock:
            more_epochs = (
                self._training_shards and self._epoch < self._num_epochs - 1
            )
            pending_callback = (
                self._train_end_callback_pending
                and not self._train_end_callback_done
            )
            return (
                not self._todo
                and not self._doing
                and not more_epochs
                and not pending_callback
            )

    def counts(self):
        with self._lock:
            return {
                "todo": len(self._todo),
                "doing": len(self._doing),
                "completed": dict(self.completed_counts),
                "failed": dict(self.failed_counts),
                "epoch": self._epoch,
            }

    # -- timeout watchdog ---------------------------------------------------

    def add_worker_timeout_callback(self, fn):
        """fn(worker_id) called when a worker times out on a task."""
        self._worker_timeout_callbacks.append(fn)

    def start(self):
        self._watchdog = threading.Thread(
            target=self._watch_timeouts, name="task-timeout-watchdog",
            daemon=True,
        )
        self._watchdog.start()

    def stop(self):
        self._stopped.set()

    def _timeout_threshold(self):
        with self._lock:
            longest = self._max_task_completed_time
        return max(self._task_timeout_secs, 3 * longest)

    def _watch_timeouts(self):
        while not self._stopped.wait(timeout=5):
            threshold = self._timeout_threshold()
            now = time.time()
            with self._lock:
                timed_out = [
                    (tid, wid) for tid, (wid, _, start) in self._doing.items()
                    if now - start > threshold
                ]
            for tid, wid in timed_out:
                logger.warning(
                    "task %d timed out on worker %s; re-queueing", tid, wid
                )
                self.report(tid, False, err_message="timeout")
                for fn in self._worker_timeout_callbacks:
                    fn(wid)
