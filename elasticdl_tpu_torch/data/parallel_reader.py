"""Multiprocess sharded reading + batch prefetching.

The reference's ``odps_io`` runs a pool of reader processes over table
shards with retrying batch reads and streams records to the trainer
(elasticdl/python/data/odps_io.py:71-400).  TPU-native equivalent, two
pieces:

 - ``ParallelShardReader``: wraps any AbstractDataReader *factory* in a
   multiprocessing pool.  A task's [start, end) range splits into
   sub-ranges; each pool process lazily builds its own reader (DB
   connections and file handles don't survive fork) and reads one
   sub-range per job, with bounded retries on transient read errors.
   Records come back in range order.

 - ``prefetch_batches``: a background-thread iterator that keeps N
   batches ready so host-side feed/decode overlaps device compute — the
   input-pipeline half of keeping the MXU busy (the device half is the
   jitted step; see worker/worker.py).

Both compose with the reader factory (data/factory.py) and the dynamic
sharding protocol unchanged: the master still hands out coarse tasks,
and parallelism here is *within* one worker's task.
"""

import multiprocessing as mp
import queue
import threading
import time
from types import SimpleNamespace

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Per-process reader cache: one reader per pool process, built lazily
# from the factory shipped with each job (factories must be picklable).
_PROC_READER = None
_PROC_FACTORY_ID = None


def _make_task(shard_name, start, end, record_indices=None):
    return SimpleNamespace(
        shard=SimpleNamespace(
            name=shard_name, start=start, end=end,
            record_indices=record_indices or [],
        )
    )


def _read_subrange(args):
    """Pool worker: read one sub-range with bounded retries."""
    global _PROC_READER, _PROC_FACTORY_ID
    factory, factory_key, shard_name, start, end, indices, max_retries = args
    if _PROC_READER is None or _PROC_FACTORY_ID != factory_key:
        _PROC_READER = factory()
        _PROC_FACTORY_ID = factory_key
    task = _make_task(shard_name, start, end, indices)
    last_err = None
    for attempt in range(max_retries):
        try:
            if _PROC_READER is None:
                _PROC_READER = factory()
            return list(_PROC_READER.read_records(task))
        except Exception as e:  # noqa: BLE001 — transient IO/DB errors
            last_err = e
            logger.warning(
                "read [%s, %d, %d) attempt %d failed: %s",
                shard_name, start, end, attempt + 1, e,
            )
            # The reader itself may be the broken part (dropped DB
            # connection): drop it so the next attempt rebuilds inside
            # the try (a factory that throws still counts against the
            # retry budget instead of escaping the loop).
            _PROC_READER = None
            time.sleep(min(2.0 ** attempt * 0.1, 2.0))
    raise RuntimeError(
        "read of [%s, %d, %d) failed after %d attempts: %s"
        % (shard_name, start, end, max_retries, last_err)
    )


class ParallelShardReader:
    """Fan a task's record range out over a process pool.

    reader_factory: picklable zero-arg callable returning an
        AbstractDataReader (e.g. ``functools.partial(SQLTableDataReader,
        db, table)``).
    """

    def __init__(self, reader_factory, num_processes=4,
                 records_per_subrange=256, max_retries=3):
        import pickle

        self._factory = reader_factory
        # Stable identity across pickling so pool processes reuse their
        # reader between jobs instead of reconnecting per sub-range.
        self._factory_key = hash(pickle.dumps(reader_factory))
        self._num_processes = num_processes
        self._per_subrange = records_per_subrange
        self._max_retries = max_retries
        ctx = mp.get_context("spawn")  # fork + grpc/jax threads = hangs
        self._pool = ctx.Pool(num_processes)

    def read_records(self, task):
        """Yield the task's records in order, read by the pool."""
        shard = task.shard
        if shard.record_indices:
            # Shuffled tasks: split the index list itself.
            chunks = [
                (self._factory, self._factory_key, shard.name,
                 shard.start, shard.end,
                 list(shard.record_indices[i:i + self._per_subrange]),
                 self._max_retries)
                for i in range(0, len(shard.record_indices),
                               self._per_subrange)
            ]
        else:
            chunks = []
            start = shard.start
            while start < shard.end:
                end = min(start + self._per_subrange, shard.end)
                chunks.append(
                    (self._factory, self._factory_key, shard.name,
                     start, end, None, self._max_retries)
                )
                start = end
        for records in self._pool.imap(_read_subrange, chunks):
            yield from records

    def close(self):
        self._pool.terminate()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_batches(batch_iter, depth=2, prepare=None):
    """Run ``batch_iter`` in a background thread, keeping up to
    ``depth`` batches ready — host feed/decode overlaps device compute.

    ``prepare`` (optional) maps each item on the PRODUCER thread before
    it is enqueued — the fused training driver passes the trainer's
    ``prepare_batch`` here so padding/reshape/globalize host work runs
    in this pipeline stage instead of on the dispatch critical path
    (docs/training_pipeline.md).  A prepare failure re-raises at the
    consumer like any producer error.

    Exceptions from the producer re-raise at the consumer's next pull,
    so failures surface in the training loop (where the minibatch retry
    machinery lives), not in a daemon thread.
    """
    q = queue.Queue(maxsize=depth)
    _END = object()
    abandoned = threading.Event()

    def _put(item):
        # Bounded put that notices an abandoned consumer: without this,
        # a training loop that breaks early would leave the producer
        # blocked on the full queue forever, pinning batch_iter's
        # resources (pools, DB connections) for the process lifetime.
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in batch_iter:
                if prepare is not None:
                    batch = prepare(batch)
                if not _put(batch):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            _put(e)
        finally:
            close = getattr(batch_iter, "close", None)
            if abandoned.is_set() and close is not None:
                close()

    thread = threading.Thread(
        target=produce, name="batch-prefetch", daemon=True
    )
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()
        # Join before returning control: the caller may immediately
        # start the next task over the SAME stateful reader (shared
        # file handles, seek+read), and two producer threads
        # interleaving on it would tear records.  The producer notices
        # abandonment between batches, so this waits at most one batch
        # read/decode.
        thread.join(timeout=60.0)
        if thread.is_alive():
            # Fail loudly: returning control would let the caller start
            # the next task over the SAME stateful reader while this
            # thread is still mid-read — torn records.  A wedged reader
            # should fail the task (the master re-queues it), not
            # corrupt the next one.
            raise RuntimeError(
                "batch-prefetch producer still running after 60s; "
                "reader wedged — failing the task instead of racing "
                "the next one"
            )
