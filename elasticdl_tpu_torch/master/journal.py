"""Job-state journal — the master's crash-restart recovery log.

The master owns the only job state that (before this module) lived
purely in process memory: the task todo/doing queues, per-worker
progress counts, the model-version high-water mark, and the rendezvous
epoch.  Workers and PS shards already survive death (requeue /
relaunch-with-restore); this journal closes the last SPOF by making the
master recoverable too.

Design (docs/master_recovery.md):

 - **Append-only, crc-framed, durably flushed.**  One file,
   ``<journal_dir>/job.journal``; each record is ``<u32 length><u32
   crc32(payload)><payload>`` with a compact-JSON payload.  A torn
   write at the tail (power cut mid-fsync) is detected by the frame
   check and dropped LOUDLY on replay; the writer truncates the file
   back to the last valid frame before appending, so a restart never
   appends after garbage.

 - **Batched at the report cadence.**  Task *lifecycle* events
   (created/done/failed/epoch/rendezvous commits) are low-rate — one
   per task, not per batch — and each requests a group-commit flush
   (write + fdatasync on a dedicated flusher thread; N concurrent
   reporters share one sync and a handler never blocks on storage).
   High-rate *progress* events (per-window ``report_batch_done``
   counts, version reports) are buffered and ride the next lifecycle
   flush (or the size threshold), so the hot path pays a list append.
   A crash inside the flusher's ms-scale window downgrades the
   not-yet-durable tasks to the system's EXISTING at-least-once
   semantics (replay requeues them, exactly like the timeout
   watchdog); their progress events ride the same ordered buffer, so
   they vanish with their task and are never double-counted.
   Progress counts are observability, task accounting is the ground
   truth.

 - **Written OUTSIDE locks.**  ``JournalWriter.append``/``flush`` are
   file I/O and must never run inside a task-manager/servicer/
   rendezvous lock region (callers collect events under the lock and
   emit after release).  elastic-lint EL006 *proves* this: the journal
   methods are in the known-blocking registry
   (tools/elastic_lint/blocking.py), so a journal call under a lock is
   a lint failure, not a code-review hope.

Replay rebuilds a :class:`JournalState`; ``TaskManager.
restore_from_journal`` re-queues in-flight tasks, restores counts and
the epoch, and keeps the set of already-completed task ids so a worker
re-reporting a task it finished just before the crash is deduplicated
(idempotent success), never double-counted.
"""

import json
import os
import struct
import threading
import time
import zlib
from collections import defaultdict

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

JOURNAL_FILE = "job.journal"
_FRAME = struct.Struct("<II")

# Event types that drive task accounting: appending one via
# `journal_events` requests a group-commit flush (write + fdatasync on
# the flusher thread).  Everything else ("batch", "version",
# "dispatch", "requeue") is buffered progress riding the next flush.
DURABLE_EVENTS = frozenset(
    {"meta", "restart", "task", "done", "fail", "trim", "epoch", "cb",
     "rdzv", "sched"}
)

# Keep a bounded progress buffer: one fsync per this many buffered
# events even when no lifecycle event forces one.
DEFAULT_FLUSH_EVERY = 256


def journal_path(journal_dir):
    return os.path.join(journal_dir, JOURNAL_FILE)


def _encode(record):
    payload = json.dumps(
        record, separators=(",", ":"), sort_keys=True
    ).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def scan_frames(data):
    """Yield (record, end_offset) for every valid frame in ``data``;
    stops LOUDLY at the first torn/corrupt frame (a crash mid-append
    legitimately leaves one) instead of crashing replay."""
    off, n = 0, len(data)
    while off < n:
        if off + _FRAME.size > n:
            logger.warning(
                "journal: truncated frame header at offset %d "
                "(%d trailing bytes dropped)", off, n - off,
            )
            return
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        if start + length > n:
            logger.warning(
                "journal: truncated record at offset %d (%d of %d "
                "payload bytes; tail dropped)", off, n - start, length,
            )
            return
        payload = data[start:start + length]
        if zlib.crc32(payload) != crc:
            logger.warning(
                "journal: crc mismatch at offset %d; dropping this "
                "and the remaining %d bytes", off, n - off,
            )
            return
        try:
            record = json.loads(payload)
        except ValueError:
            logger.warning(
                "journal: undecodable payload at offset %d; tail "
                "dropped", off,
            )
            return
        off = start + length
        yield record, off


class JournalWriter:
    """Thread-safe append-only writer.  ``append`` buffers; ``kick``
    requests a durable flush from the background flusher thread
    (group commit: one ``write`` + ``fdatasync`` covers every event
    buffered by then, so N concurrent reporters share one sync and an
    RPC handler never blocks on storage); ``flush`` is the synchronous
    drain for close/restart-marker/shutdown paths.  Opening an
    existing journal truncates any torn tail frame first (see module
    doc)."""

    def __init__(self, journal_dir, flush_every=DEFAULT_FLUSH_EVERY):
        os.makedirs(journal_dir, exist_ok=True)
        self._path = journal_path(journal_dir)
        # Two locks, strictly ordered _io_lock -> _lock: ``_lock``
        # guards ONLY the event buffer (what ``append`` needs, never
        # held across storage I/O), ``_io_lock`` serializes
        # write+fdatasync so concurrent flushes keep the buffer swaps
        # and the on-disk record order identical.
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buf = []
        self._flush_every = max(1, int(flush_every))
        self._closed = False
        self._closing = False
        self._dirty = False
        valid = 0
        if os.path.exists(self._path):
            with open(self._path, "rb") as fh:
                data = fh.read()
            for _, end in scan_frames(data):
                valid = end
            if valid != len(data):
                logger.warning(
                    "journal: truncating %s from %d to last valid "
                    "frame at %d before appending",
                    self._path, len(data), valid,
                )
        self._fh = open(self._path, "ab")
        if valid != self._fh.tell():
            self._fh.truncate(valid)
            self._fh.seek(valid)
        self._flusher = threading.Thread(
            target=self._flush_loop, name="journal-flusher", daemon=True
        )
        self._flusher.start()

    def append(self, record):
        """Buffer one event; requests a flush at the size threshold."""
        # Encode outside the lock: the buffer lock is shared by every
        # RPC handler thread, and json+crc work doesn't need it.
        encoded = _encode(record)
        with self._lock:
            if self._closed:
                return
            self._buf.append(encoded)
            need_flush = len(self._buf) >= self._flush_every
        if need_flush:
            self.kick()

    def kick(self):
        """Request an asynchronous durable flush of everything
        buffered so far.  Returns immediately — the caller's events
        become durable within one flusher turnaround (ms), and a crash
        inside that window loses only events the system already
        tolerates losing: a not-yet-durable ``done`` replays as a
        requeue (the repo's existing at-least-once task semantics, the
        same as the timeout watchdog), and its progress events ride
        the SAME ordered buffer so they vanish with it, never
        double-counted."""
        # self._cv wraps self._lock, so holding the lock is holding
        # the condition's lock (and keeps EL001's guard map exact).
        with self._lock:
            self._dirty = True
            self._cv.notify()

    def _flush_loop(self):
        while True:
            with self._lock:
                while not (self._dirty or self._closing):
                    self._cv.wait()
                if not self._dirty:
                    return          # closing and drained: close() owns
                self._dirty = False
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 — the flusher must
                # outlive transient storage errors (ENOSPC, EIO, cgroup
                # throttle): flush() re-queued the events and re-armed
                # _dirty, so back off briefly and retry.  A dead
                # flusher would silently end durability while appends
                # accumulate unbounded.
                logger.error(
                    "journal: flush failed (%s); events re-queued, "
                    "retrying", e,
                )
                time.sleep(1.0)

    def flush(self):
        """Synchronous drain: write the buffer in one ``write`` and
        make it durable before returning.  The buffer is swapped out
        under ``_lock`` and the write+fdatasync runs under ``_io_lock``
        only, so a concurrent ``append`` (an RPC handler) NEVER waits
        on storage — a throttled fdatasync stalls the flusher, not the
        control plane."""
        with self._io_lock:
            with self._lock:
                if self._closed or not self._buf:
                    return
                blob = b"".join(self._buf)
                self._buf = []
            pos = self._fh.tell()
            try:
                self._fh.write(blob)
                self._fh.flush()
                # fdatasync, not fsync: the log is append-only, so the
                # only metadata a replay needs is the file size — which
                # fdatasync is required to make durable when it changed
                # (POSIX: "all I/O needed to retrieve the data").  ~40%
                # cheaper per durable event on this class of filesystem.
                os.fdatasync(self._fh.fileno())
            except Exception:
                # Self-heal: rewind any partial write (replay stops at
                # the first bad frame, so a torn frame MID-file would
                # poison everything after it) and put the events back
                # at the buffer front so a later flush retries
                # byte-identically.
                try:
                    self._fh.truncate(pos)
                    self._fh.seek(pos)
                except Exception:  # noqa: BLE001 — rewind best-effort
                    logger.error(
                        "journal: could not rewind after failed "
                        "flush; tail may be torn (replay tolerates)",
                    )
                with self._lock:
                    if not self._closed:
                        self._buf.insert(0, blob)
                        self._dirty = True
                raise

    def close(self):
        with self._lock:
            if self._closed or self._closing:
                return
            self._closing = True
            self._cv.notify_all()
        self._flusher.join(timeout=10)
        self.flush()
        with self._io_lock:
            with self._lock:
                self._closed = True
            self._fh.close()


def journal_events(journal, events):
    """Append a batch of events; request one group-commit flush if any
    is durable (the handler never blocks on storage — see
    ``JournalWriter.kick``).  No-op for ``journal=None`` so call sites
    stay unconditional.  MUST be called outside lock regions
    (EL006-enforced)."""
    if journal is None or not events:
        return
    durable = False
    for event in events:
        journal.append(event)
        durable = durable or event.get("ev") in DURABLE_EVENTS
    if durable:
        journal.kick()


class JournalState:
    """Replayed job state (see ``replay_journal``)."""

    def __init__(self):
        self.meta = None
        self.tasks = {}            # id -> task event dict
        self.status = {}           # id -> "todo" | "doing" | "done" | "failed"
        self.retries = {}          # id -> retry count at last fail
        self.completed_counts = defaultdict(int)   # task type -> n
        self.failed_counts = defaultdict(int)
        self.epoch = 0
        self.max_task_id = 0
        self.worker_records = defaultdict(int)     # worker id -> records
        self.records_done = 0
        self.model_version = 0
        self.rendezvous_id = 0
        self.restarts = 0
        self.train_end_pending = False
        self.train_end_created = False
        # Multi-tenant scheduler records (docs/scheduler.md): the
        # scheduler journal's "sched" events rebuild the worker->job
        # assignment map and the per-job admission state, so a master
        # killed MID-RESIZE replays to a consistent schedule (the
        # decision is journaled write-ahead of its effects).
        self.sched_assignments = {}     # worker id -> job id
        self.sched_jobs = {}            # job id -> {"name", "state"}
        self.sched_decisions = defaultdict(int)   # op -> count

    @property
    def done_ids(self):
        return {tid for tid, s in self.status.items() if s == "done"}

    def pending_tasks(self):
        """Tasks to rebuild the queue from: in-flight first (they were
        dispatched when the master died and must be requeued), then
        never-finished todo tasks, both in id order — the original
        creation order of the deque."""
        doing = sorted(
            tid for tid, s in self.status.items() if s == "doing"
        )
        todo = sorted(
            tid for tid, s in self.status.items() if s == "todo"
        )
        return [self.tasks[tid] for tid in doing + todo]

    def counts(self):
        return {
            "tasks": len(self.tasks),
            "done": sum(1 for s in self.status.values() if s == "done"),
            "doing": sum(1 for s in self.status.values() if s == "doing"),
            "todo": sum(1 for s in self.status.values() if s == "todo"),
            "failed": sum(
                1 for s in self.status.values() if s == "failed"
            ),
            "epoch": self.epoch,
            "records_done": self.records_done,
            "rendezvous_id": self.rendezvous_id,
            "restarts": self.restarts,
        }

    # -- event application --------------------------------------------------

    def apply(self, rec):
        ev = rec.get("ev")
        if ev == "meta":
            self.meta = rec.get("job", {})
        elif ev == "restart":
            self.restarts += 1
        elif ev == "task":
            tid = rec["id"]
            self.tasks[tid] = rec
            self.status[tid] = "todo"
            self.max_task_id = max(self.max_task_id, tid)
        elif ev == "dispatch":
            tid = rec["id"]
            if self.status.get(tid) == "todo":
                self.status[tid] = "doing"
        elif ev == "done":
            tid = rec["id"]
            if self.status.get(tid) not in (None, "done"):
                self.status[tid] = "done"
                self.completed_counts[self.tasks[tid]["type"]] += 1
        elif ev == "fail":
            tid = rec["id"]
            if self.status.get(tid) in ("todo", "doing"):
                self.retries[tid] = max(
                    self.retries.get(tid, 0), rec.get("retries", 0)
                )
                if rec.get("perm"):
                    self.status[tid] = "failed"
                    self.failed_counts[self.tasks[tid]["type"]] += 1
                else:
                    self.status[tid] = "todo"
        elif ev == "requeue":
            tid = rec["id"]
            if self.status.get(tid) == "doing":
                self.status[tid] = "todo"
        elif ev == "trim":
            task = self.tasks.get(rec["id"])
            if task is not None:
                trim = rec["start"] - task["start"]
                task["start"] = rec["start"]
                if task.get("idx") and trim > 0:
                    task["idx"] = task["idx"][trim:]
        elif ev == "epoch":
            self.epoch = max(self.epoch, rec["n"])
        elif ev == "cb":
            self.train_end_pending = True
        elif ev == "batch":
            self.worker_records[rec["w"]] += rec["n"]
            self.records_done += rec["n"]
        elif ev == "version":
            self.model_version = max(self.model_version, rec["v"])
        elif ev == "rdzv":
            self.rendezvous_id = max(self.rendezvous_id, rec["n"])
        elif ev == "sched":
            self._apply_sched(rec)
        else:
            logger.warning("journal: unknown event %r ignored", ev)

    def _apply_sched(self, rec):
        """One scheduler decision (record shapes in docs/scheduler.md):
        submit/admit/finish drive a job's admission state, assign moves
        a worker between jobs (``prev`` is its old job, 0 = fresh
        registration), release returns it to the unassigned pool.
        Later events win — replaying the whole journal yields exactly
        the assignment map the crashed master had made durable."""
        op = rec.get("op")
        if op in ("submit", "admit", "finish", "assign", "release"):
            # Count only ops this binary knows: a journal from a newer
            # master may carry future ops, and replayed counters must
            # match what this master would have counted live.
            self.sched_decisions[op] += 1
        if op == "submit":
            self.sched_jobs[rec["job"]] = {
                "name": rec.get("name", ""), "state": "pending",
            }
        elif op == "admit":
            self.sched_jobs.setdefault(
                rec["job"], {"name": "", "state": "pending"}
            )["state"] = "running"
        elif op == "finish":
            self.sched_jobs.setdefault(
                rec["job"], {"name": "", "state": "running"}
            )["state"] = "finished"
        elif op == "assign":
            self.sched_assignments[rec["w"]] = rec["job"]
        elif op == "release":
            self.sched_assignments.pop(rec["w"], None)
        else:
            logger.warning("journal: unknown sched op %r ignored", op)

    def finish(self):
        """Derived flags after the last event."""
        from elasticdl_tpu_torch.proto import elastic_pb2 as pb

        self.train_end_created = any(
            t.get("type") == pb.TRAIN_END_CALLBACK
            for t in self.tasks.values()
        )
        return self


def replay_journal(journal_dir):
    """Rebuild the job state from the journal; None when the directory
    holds no journal (fresh start) or the journal has no records."""
    path = journal_path(journal_dir)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        data = fh.read()
    state = JournalState()
    records = [record for record, _ in scan_frames(data)]
    n = len(records)
    # Two-pass apply: task CREATION records first, then everything
    # else in file order.  Handlers journal outside their locks, so a
    # stalled creator (say, the epoch-rollover get()) can append its
    # 'task' records AFTER another thread's 'dispatch'/'done' for
    # those very tasks reached the buffer; applying creations first
    # keeps such a completion from being silently dropped — and the
    # finished task from being re-run — on replay.  Lifecycle events
    # are order-tolerant given the task exists ('done' is absorbing,
    # 'dispatch' only applies from todo), and task ids are never
    # reused across restarts, so hoisting creations is safe.
    for record in records:
        if record.get("ev") == "task":
            state.apply(record)
    for record in records:
        if record.get("ev") != "task":
            state.apply(record)
    if n == 0:
        return None
    state.finish()
    logger.info(
        "journal: replayed %d records from %s: %s", n, path,
        state.counts(),
    )
    return state
