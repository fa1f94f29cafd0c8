"""Dynamic request micro-batching for the serving hot path.

The TF-Serving/Triton request-batcher role, TPU-native and in-process.
Without it the server executes exactly one predict per model at a time:
every HTTP thread takes the endpoint's execution lock and dispatches its
own ``exported.call``, so under concurrency the accelerator idles behind
a lock convoy and per-request dispatch overhead — and every distinct
request batch size is a fresh concrete shape (= a fresh XLA compile) for
the polymorphic export.

With it, request threads only marshal (JSON decode -> numpy) and enqueue
``(inputs, future)`` into an admission queue; a dedicated executor
thread per model coalesces concurrent requests up to ``max_batch_size``
rows or ``batch_timeout_ms`` (whichever comes first), pads the coalesced
batch up to a small fixed set of bucket sizes (so the compiled-shape set
is bounded and pre-warmable), runs ONE ``model.predict``, slices the
padded output back per request, and resolves the futures.  Only device
execution is serialized — and it runs at full batch occupancy.  This is
the inference-side counterpart of the training path's overlapped PS
pipeline (docs/ps_pipeline.md); the logical-vs-hardware batch decoupling
follows VirtualFlow's virtual-node batching (PAPERS.md).

Version discipline under hot-swap: a request carries the exact
``(model, dtypes)`` snapshot it was marshalled against, and the executor
groups requests by model identity — so a batch can never mix model
versions, and requests admitted before a swap finish on the model they
were decoded for (the same "in-flight predicts finish on the old model"
contract the lock path has).  The executor calls the endpoint's
``maybe_reload`` strictly BETWEEN batches, never mid-batch.

Embedding ``:lookup`` requests ride the same admission queue (host-side
numpy: concatenate ids, one table read, split the vectors), so lookups
serialize with predicts instead of racing the swap.
"""

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.timing import Timing

logger = get_logger(__name__)

_SHUTDOWN = object()

# Coalescing cap for :lookup requests (rows of ids per executed lookup).
# Lookups are host-side numpy — batching them is about keeping ONE
# execution point (no swap races), not device occupancy — so the cap
# only bounds transient memory, independent of the predict bucket set.
LOOKUP_MAX_ROWS = 4096


def default_buckets(max_batch_size):
    """Powers of two up to ``max_batch_size``, always including it."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1, got %d"
                         % max_batch_size)
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


def pick_bucket(n, buckets):
    """Smallest bucket >= n (buckets sorted ascending); the caller caps
    coalescing at buckets[-1], so n always fits."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class BatchConfig:
    """Knobs for one model's micro-batcher (CLI: --max_batch_size,
    --batch_timeout_ms, --pad_buckets, --warm_buckets)."""

    def __init__(self, max_batch_size=32, batch_timeout_ms=2.0,
                 pad_buckets=None, warm=True):
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.batch_timeout_ms = float(batch_timeout_ms)
        if self.batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0")
        buckets = sorted({int(b) for b in (
            pad_buckets if pad_buckets
            else default_buckets(self.max_batch_size))})
        if buckets[0] < 1:
            raise ValueError("pad_buckets must be positive: %r"
                             % (buckets,))
        if buckets[-1] < self.max_batch_size:
            # The top bucket must cover a full coalesced batch.
            buckets.append(self.max_batch_size)
        self.pad_buckets = buckets

        self.warm = bool(warm)

    @property
    def enabled(self):
        return self.max_batch_size > 1

    def describe(self):
        return {
            "max_batch_size": self.max_batch_size,
            "batch_timeout_ms": self.batch_timeout_ms,
            "pad_buckets": list(self.pad_buckets),
            "warm_buckets": self.warm,
        }


def is_leaf_signature(sig):
    """True when ``sig`` is the leaf schema itself ({"shape": [...],
    "dtype": "..."}) — key presence alone is not enough: a dict-INPUT
    model whose feature names happen to include "shape"/"dtype" must
    not be misread as single-input.  Shared by the server's dtype map
    and the batch plan (the standalone loader keeps its own copy BY
    DESIGN — it must stay vendorable with zero framework imports)."""
    return (isinstance(sig, dict)
            and isinstance(sig.get("shape"), (list, tuple))
            and isinstance(sig.get("dtype"), str))


def batch_plan(manifest):
    """How to batch requests for this export, or None if it can't be.

    Batchable means: the export has a free (symbolic) leading batch dim
    (``polymorphic_batch``) and a REST-servable signature — one array,
    or a flat dict of arrays where at least one leaf is batched (leading
    dim ``None``).  Rank-0 / fixed-shape leaves (scalar temperatures,
    seeds) are "aux": requests only coalesce when their aux leaves are
    bit-identical, because those leaves are shared by the whole executed
    batch.
    """
    if not manifest.get("polymorphic_batch"):
        return None
    sig = manifest.get("input_signature")
    if is_leaf_signature(sig):
        if sig["shape"] and sig["shape"][0] is None:
            return {"mode": "array"}
        return None
    if isinstance(sig, dict):
        batched = {
            key for key, sub in sig.items()
            if is_leaf_signature(sub) and sub["shape"]
            and sub["shape"][0] is None
        }
        if batched and all(is_leaf_signature(sub) for sub in sig.values()):
            return {"mode": "dict", "batched": frozenset(batched)}
    return None


class _Request:
    __slots__ = ("kind", "key", "model", "inputs", "n", "future",
                 "t_enq")

    def __init__(self, kind, key, model, inputs, n):
        self.kind = kind      # "predict" | "lookup" | "raw"
        self.key = key        # coalescing key (same key => same batch)
        self.model = model    # the marshalling-time model snapshot
        self.inputs = inputs  # ndarray | {name: ndarray} | (table, ids)
        self.n = n            # batch rows this request contributes
        self.future = Future()
        self.t_enq = time.monotonic()


def _aux_key(arr):
    """Hashable identity for an aux (non-batched) input leaf: requests
    coalesce only when these match bit-for-bit."""
    arr = np.asarray(arr)
    return (arr.dtype.str, arr.shape, arr.tobytes())


class ModelBatcher:
    """Admission queue + executor thread for one ModelEndpoint.

    Thread roles: N HTTP request threads call ``predict``/``lookup``
    (marshal, enqueue, block on a future); ONE executor thread owns all
    device execution and is the only place ``reload_fn`` (the
    endpoint's ``maybe_reload``) takes effect on the serving path —
    between batches, never mid-batch.
    """

    def __init__(self, config, reload_fn=None, execute_lock=None,
                 timing=None, name="model"):
        self.config = config
        self.name = name
        self._reload_fn = reload_fn
        # The endpoint's execution lock: uncontended in steady state
        # (this executor is the only predict path), but kept so direct
        # endpoint.predict callers and the executor can never run
        # ``exported.call`` concurrently.
        self._exec_lock = execute_lock or threading.Lock()
        self.timing = timing if timing is not None else Timing()
        self._queue = queue.Queue()
        # Pressure-aware grace (executor-thread-only state): the
        # coalescing loop block-waits for the batch window ONLY when
        # the previous predict cycle saw companion traffic; an isolated
        # request on an idle server flushes immediately instead of
        # paying the full timeout as pure added latency.
        self._had_company = False
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="batcher-%s" % name)
        self._thread.start()

    # -- request-thread API --------------------------------------------

    def predict(self, model, plan, inputs):
        """Enqueue one marshalled predict; block until its slice of the
        batched output is ready.  Exceptions from execution re-raise
        here (so the HTTP error mapping is unchanged)."""
        kind, key, n = self._predict_key(model, plan, inputs)
        return self._submit(_Request(kind, key, model, inputs, n))

    def lookup(self, model, table, ids):
        """Enqueue one embedding lookup; rows come back in request
        order.  Rides the same queue as predicts so a lookup never
        races a hot-swap mid-read."""
        ids = np.asarray(ids)
        request = _Request("lookup", ("l", table), model,
                           (table, ids), int(ids.size))
        return self._submit(request)

    def _submit(self, request):
        if self._closed.is_set():
            raise RuntimeError("batcher for %r is shut down" % self.name)
        self._queue.put(request)
        if self._closed.is_set():
            # close() may have finished its drain between our check
            # and our put: with the executor gone nothing else would
            # ever resolve this future, so drain again ourselves.
            self._drain_pending()
        return request.future.result()

    def _predict_key(self, model, plan, inputs):
        """(kind, key, rows) for coalescing.  Unbatchable requests get
        kind "raw" with a unique key: they still run on the executor
        (one execution point, swap-safe) but are never coalesced or
        padded — exactly one ``model.predict(inputs)``."""
        top = self.config.pad_buckets[-1]
        if plan is not None and plan["mode"] == "array":
            arr = np.asarray(inputs)
            if arr.ndim >= 1 and 1 <= arr.shape[0] <= top:
                return ("predict",
                        ("a", arr.dtype.str, arr.shape[1:]),
                        arr.shape[0])
        elif plan is not None and plan["mode"] == "dict" and (
                isinstance(inputs, dict)):
            batched = plan["batched"]
            if batched <= set(inputs):
                leads = {np.asarray(inputs[k]).shape[0:1] or (0,)
                         for k in batched}
                lead = leads.pop() if len(leads) == 1 else (0,)
                if 1 <= lead[0] <= top:
                    key = tuple(
                        (k, "b", np.asarray(v).dtype.str,
                         np.asarray(v).shape[1:])
                        if k in batched else (k, "x") + _aux_key(v)
                        for k, v in sorted(inputs.items())
                    )
                    return "predict", ("d", key), lead[0]
        # (Counted in _execute, on the executor thread — Timing bumps
        # keep a single writer.)
        return "raw", ("raw", object()), 1

    # -- executor ------------------------------------------------------

    def close(self):
        """Shut the executor down; pending requests fail fast."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._queue.put(_SHUTDOWN)
        self._thread.join(timeout=30)
        self._drain_pending()

    def _drain_pending(self):
        saw_shutdown = False
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                saw_shutdown = True
                continue
            if not item.future.done():
                try:
                    item.future.set_exception(
                        RuntimeError("server shutting down"))
                except InvalidStateError:
                    pass  # close() and a racing _submit both drain
        if saw_shutdown:
            # Never swallow the executor's stop signal: a racing
            # _submit's drain can run while the executor is still
            # mid-batch — without the re-put it would block on
            # queue.get() forever and close() would burn its join
            # timeout.  (After the executor exits, the re-put sentinel
            # is inert.)
            self._queue.put(_SHUTDOWN)

    def _run(self):
        carry = None
        while True:
            if carry is not None:
                head, carry = carry, None
            else:
                head = self._queue.get()
            if head is _SHUTDOWN:
                break
            if self._reload_fn is not None:
                # Hot-swaps take effect HERE, strictly between batches.
                try:
                    self._reload_fn()
                except Exception as e:  # noqa: BLE001 — a failed
                    # rescan must not kill the executor; the old model
                    # keeps serving.
                    logger.warning("reload check failed: %s", e)
            group, carry = self._coalesce(head)
            self._execute(group)
        self._drain_pending()

    def _coalesce(self, head):
        """Collect requests compatible with ``head`` until the row cap
        or the head's deadline.  Returns (group, carried_item): the
        first incompatible item is carried to the next cycle so FIFO
        order is preserved across groups.

        Everything already queued is drained without waiting (requests
        accumulate behind the previous batch's execution — the batching
        win needs no artificial delay).  Block-waiting for the
        ``batch_timeout_ms`` window happens only under pressure (the
        previous predict cycle had companion traffic): a lone request
        on an idle server flushes immediately, so batching adds zero
        latency at concurrency 1 while still filling batches when a
        burst arrives staggered."""
        group, rows = [head], head.n
        if head.kind == "predict":
            cap = self.config.max_batch_size
            deadline = head.t_enq + self.config.batch_timeout_ms / 1e3
            allow_wait = self._had_company
        elif head.kind == "lookup":
            # Drain-only: host-side lookups gain nothing from waiting.
            cap, deadline, allow_wait = LOOKUP_MAX_ROWS, 0.0, False
        else:  # raw: never coalesced
            return group, None
        def flush_bump(name):
            # Flush-reason counters describe PREDICT batching; lookup
            # groups stay out of them, mirroring the lookup_batches /
            # lookup_rows separation in _execute.
            if head.kind == "predict":
                self.timing.bump(name)

        carried = None
        while rows < cap:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                if not allow_wait:
                    flush_bump("batcher.empty_flushes")
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    flush_bump("batcher.timeout_flushes")
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    flush_bump("batcher.timeout_flushes")
                    break
            if nxt is _SHUTDOWN:
                carried = nxt
                break
            if (nxt.kind != head.kind or nxt.key != head.key
                    or nxt.model is not head.model
                    or rows + nxt.n > cap):
                flush_bump("batcher.incompatible_flushes")
                carried = nxt
                break
            group.append(nxt)
            rows += nxt.n
        else:
            flush_bump("batcher.size_flushes")
        if head.kind == "predict":
            self._had_company = len(group) > 1 or carried is not None
        return group, carried

    def _execute(self, group):
        t0 = time.monotonic()
        rows = sum(r.n for r in group)
        kind = group[0].kind
        if kind == "lookup":
            # Separate counters: host-side lookup traffic must not
            # distort the device-batch occupancy numbers.
            self.timing.bump("batcher.lookup_batches")
            self.timing.bump("batcher.lookup_rows", rows)
        elif kind == "raw":
            # Likewise uncoalescible requests: counting their
            # batches-of-one into batches/rows would drag the mean
            # occupancy toward 1 even when real batches run full.
            self.timing.bump("batcher.raw_requests")
        else:
            self.timing.bump("batcher.batches")
            self.timing.bump("batcher.rows", rows)
        self.timing.bump("batcher.requests", len(group))
        for r in group:
            self.timing.observe("batcher.queue_wait", t0 - r.t_enq)
        try:
            with self.timing.timeit(
                    "batcher.lookup_execute" if kind == "lookup"
                    else "batcher.execute"):
                if kind == "lookup":
                    self._execute_lookup(group)
                elif kind == "raw":
                    with self._exec_lock:
                        out = group[0].model.predict(group[0].inputs)
                    group[0].future.set_result(out)
                else:
                    self._execute_predict(group, rows)
        except Exception as e:  # noqa: BLE001 — an execution failure
            # (bad input shapes, an XLA error) must fail THESE futures
            # and keep the executor alive for later batches.
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)

    def _execute_predict(self, group, rows):
        model = group[0].model
        total = pick_bucket(rows, self.config.pad_buckets)
        if total > rows:
            self.timing.bump("batcher.padded_rows", total - rows)
        if isinstance(group[0].inputs, dict):
            # Aux leaves are key-identical across the group; take them
            # from the head.  Batched leaves concatenate in order.
            inputs = {}
            for key, value in group[0].inputs.items():
                if self._dict_key_is_batched(group[0], key):
                    inputs[key] = _pad_rows(np.concatenate(
                        [np.asarray(r.inputs[key]) for r in group]),
                        total)
                else:
                    inputs[key] = np.asarray(value)
        else:
            inputs = _pad_rows(np.concatenate(
                [np.asarray(r.inputs) for r in group]), total)
        with self._exec_lock:
            outputs = model.predict(inputs)
        outputs = _tree_numpy(outputs)
        out_sig = model.manifest.get("output_signature")
        start = 0
        for r in group:
            r.future.set_result(
                _tree_slice(outputs, out_sig, start, r.n, total))
            start += r.n

    @staticmethod
    def _dict_key_is_batched(head, key):
        # head.key == ("d", ((name, "b"|"x", ...), ...)) — recover the
        # per-leaf role recorded at admission time.
        for entry in head.key[1]:
            if entry[0] == key:
                return entry[1] == "b"
        return False

    def _execute_lookup(self, group):
        model = group[0].model
        table = group[0].inputs[0]
        ids = np.concatenate(
            [np.asarray(r.inputs[1]).ravel() for r in group]) \
            if len(group) > 1 else np.asarray(group[0].inputs[1])
        vectors = model.lookup_embedding(table, ids)
        start = 0
        for r in group:
            r.future.set_result(vectors[start:start + r.n])
            start += r.n


def _pad_rows(arr, total):
    """Pad a coalesced batch up to its bucket (``total`` rows) by
    repeating the first row — always valid data (zeros could be poison
    for e.g. normalizing models), and padded rows are sliced away
    before any response, so they can never leak."""
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)])


def _tree_numpy(outputs):
    """Materialize every output leaf as numpy ONCE per batch; the
    per-request slices below are then views."""
    if isinstance(outputs, dict):
        return {k: _tree_numpy(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return [_tree_numpy(v) for v in outputs]
    return np.asarray(outputs)


def _tree_slice(outputs, sig, start, n, total):
    """Per-request slice of the padded batch output.

    The export's ``output_signature`` (leading dim ``None`` = batched)
    decides which leaves slice and which (a scalar metric, a fixed
    aux output) are shared by every request.  Exports that predate the
    signature fall back to the shape heuristic — leading dim equals
    the padded batch — which can only mis-classify an aux leaf whose
    fixed size coincides with the bucket."""
    if isinstance(outputs, dict):
        sub = sig if isinstance(sig, dict) and (
            not is_leaf_signature(sig)) else {}
        return {k: _tree_slice(v, sub.get(k), start, n, total)
                for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        subs = (sig if isinstance(sig, (list, tuple))
                and len(sig) == len(outputs) else [None] * len(outputs))
        return [_tree_slice(v, s, start, n, total)
                for v, s in zip(outputs, subs)]
    if is_leaf_signature(sig):
        if sig["shape"] and sig["shape"][0] is None and (
                outputs.ndim >= 1):
            return outputs[start:start + n]
        return outputs
    if outputs.ndim >= 1 and outputs.shape[0] == total:
        return outputs[start:start + n]
    return outputs
