"""Model server over a servable export: the TF-Serving REST surface
(counterpart of ``elasticdl_tpu/serving/server.py``):

  GET  /v1/models/<name>            -> model metadata (manifest)
  GET  /v1/models/<name>/metadata   -> the same
  GET  /healthz                     -> {"status": "ok"}; 503 draining
  GET  /statz                       -> batching/queue/latency counters
  GET  /metrics                     -> the same in Prometheus text
  GET  /tracez, /alertz, /profilez  -> flight recorder, SLO watchdog,
                                       torch.profiler capture
  GET  /fleet/state                 -> per-model serving/prepared
                                       versions (fleet barrier protocol)
  POST /fleet/prepare {"version"}   -> background-load + warm a version
  POST /fleet/commit  {"version"}   -> atomically publish a prepared one
  POST /v1/models/<name>:predict    -> {"predictions": [...],
       body {"instances": [...]}        "model_version": v}
       or   {"inputs": [...]}
       or   {"inputs": {name: ...}}  (a dict-input servable, such as a
                                      sampling generation export:
                                      {"prompt": [[ids]], "seed": s})
  POST /v1/models/<name>:lookup     -> {"vectors": [...],
       body {"table": t, "ids": [...]}    "model_version": v}

``:predict`` and ``:lookup`` also take the binary frame wire
(``utils/tensor_codec.py``, content type ``FRAME_CONTENT_TYPE``) and
answer in it; errors are always JSON.  Responses carry the
``model_version`` that served them.  ``:lookup`` reads the export's
embedded tables, or, with ``--ps_addrs``, the training parameter servers
through ``serving/embedding_service.py``.

Under load the hot path is the micro-batcher (``serving/batcher.py``):
request threads marshal and enqueue, one executor thread per model
coalesces concurrent requests into padded batches of a few bucket sizes
and runs one ``predict`` for them.  Every bucket runs once at load and
at each hot-swap (``_warm_buckets``), so cuDNN's set-up for a batch size
is paid before traffic.  ``--max_batch_size 1`` (or ``--enable_batching
false``) keeps one predict at a time under an execution lock.  A
replica under a fleet router (``--fleet_managed true``) changes version
only through the router's prepare/commit barrier; on SIGTERM it drains:
new requests get 503 + ``Connection: close``, admitted ones finish, then
the process exits.

Where this module differs from the reference:
 - the model runs on the card unless the caller asks for the CPU
   (``ModelEndpoint(..., device="cpu")``; ``main`` reads
   ``ELASTICDL_TORCH_DEVICE``, default ``cuda``); there is no
   ``ELASTICDL_TPU_PLATFORM`` switch;
 - ``main`` turns TF32 off for the process
   (``utils.device.use_float32_numerics``) before it loads a model, so
   float32 predictions compute in float32; a library caller sets the
   numerics it wants;
 - JSON and frame inputs are marshalled against the manifest's input
   signature, each leaf in its dtype and checked against its shape (a
   mismatch is a 400, not a model failure), and ``"inputs"`` may hold
   an array-input model's array;
 - the live ``(model, signature, plan)`` triple holds the input
   signature where the reference holds a dtype map;
 - the server listens with a backlog of 128 connections, not
   ThreadingHTTPServer's 5, which resets clients that connect at once.

Run: python -m elasticdl_tpu_torch.serving.server --export_dir D [--port P]
"""

import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from elasticdl_tpu_torch.serving.batcher import (
    BatchConfig,
    ModelBatcher,
    batch_plan,
)
from elasticdl_tpu_torch.serving.loader import (
    is_leaf_signature,
    load_servable,
    resolve_export_dir,
)
from elasticdl_tpu_torch.utils import slo as slo_mod
from elasticdl_tpu_torch.utils import tensor_codec
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.args import build_serving_parser
from elasticdl_tpu_torch.utils.device import use_float32_numerics
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.prom import serving_to_prometheus
from elasticdl_tpu_torch.utils.timing import Timing

logger = get_logger(__name__)


def _marshal_leaf(value, signature, name):
    arr = np.asarray(value, dtype=signature["dtype"])
    want = signature["shape"]
    if arr.ndim != len(want) or any(
            w is not None and w != d for w, d in zip(want, arr.shape)):
        raise ValueError("%s of shape %s, model takes %s (None: any)"
                         % (name, arr.shape, want))
    return arr


def _marshal(rows, signature):
    """JSON rows or frame views -> the ndarray, or flat dict of
    ndarrays, that the manifest's input signature names, each leaf in
    its dtype (a view that already has it is not copied) and checked
    against its shape."""
    if is_leaf_signature(signature):
        return _marshal_leaf(rows, signature, "inputs")
    if not isinstance(rows, dict) or set(rows) != set(signature):
        raise ValueError("inputs must be an object with the keys %s"
                         % sorted(signature))
    return {key: _marshal_leaf(rows[key], sub, key)
            for key, sub in signature.items()}


def _jsonable(outputs):
    """Model output tree (array | tuple | list | dict) -> JSON: ndarray
    leaves (the batcher hands back numpy views) by one ``.tolist()``,
    numpy scalars by ``.item()``, plain scalars and strings as they are,
    anything else through ``np.asarray``."""
    if isinstance(outputs, np.ndarray):
        return outputs.tolist()
    if isinstance(outputs, np.generic):
        return outputs.item()
    if isinstance(outputs, dict):
        return {k: _jsonable(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return [_jsonable(v) for v in outputs]
    if outputs is None or isinstance(outputs, (bool, int, float, str)):
        return outputs
    return np.asarray(outputs).tolist()


def _version_of(model):
    return int(model.manifest.get("version", 0) or 0)


class ModelEndpoint:
    """One loaded servable plus request/response marshalling.

    When ``export_dir`` is a versioned base (``<base>/<N>/``) the
    endpoint serves the newest complete version and hot-swaps when a
    newer one appears: the scan runs at most once per ``poll_interval``
    seconds, the new servable loads and warms outside the execution
    lock and is published by one assignment, so in-flight and in-queue
    predicts finish on the model they were admitted under.  A
    ``fleet_managed`` endpoint never scans: its versions arrive through
    ``prepare_version`` / ``commit_version``.  ``batching``: a
    ``BatchConfig`` (None, or ``max_batch_size`` 1, keeps one predict
    at a time under the execution lock).  ``boot_version`` pins the
    first load to one version."""

    def __init__(self, export_dir, name=None, poll_interval=2.0,
                 device=None, batching=None, fleet_managed=False,
                 embedding_service=None, boot_version=None):
        self.export_dir = export_dir
        self.poll_interval = poll_interval
        self._device = device
        self.fleet_managed = bool(fleet_managed)
        # PS-backed embedding lookups; the service's cache is keyed by
        # this model's version, re-keyed on every publish.
        self._embedding_service = embedding_service
        self.model = load_servable(
            export_dir if boot_version is None
            else resolve_export_dir(export_dir, version=boot_version),
            device=device)
        self._versioned = not os.path.isfile(
            os.path.join(export_dir, "manifest.json"))
        self._loaded_dir = self.model.export_dir
        self._last_scan = time.monotonic()
        self.name = name or self.model.manifest.get("model_name") or "model"
        self._batching = batching if (
            batching is not None and batching.enabled) else None
        self.timing = Timing()
        plan = self._plan(self.model)
        # (model, input signature, plan) as one tuple: one assignment
        # publishes it, so a request never marshals against one
        # version's signature and runs another version's weights.
        self._active = (self.model, self.model.manifest["input_signature"],
                        plan)
        self._lock = threading.Lock()         # model execution
        self._reload_lock = threading.Lock()  # scan/load/swap, barrier
        self._batcher = None
        self._reload_thread = None
        # Fleet barrier slots, guarded by _reload_lock: the version being
        # prepared, the warm prepared servable waiting for its commit
        # (version, model, signature, plan), the last prepare failure.
        self._preparing = None
        self._prepared = None
        self._prepare_error = None
        self._prepare_thread = None
        if self._embedding_service is not None:
            self._embedding_service.set_version(self.serving_version())
        if self._batching is not None:
            self._warm_buckets(self.model, plan)
            self._batcher = ModelBatcher(
                self._batching, reload_fn=self.maybe_reload,
                execute_lock=self._lock, timing=self.timing,
                name=self.name)

    def _plan(self, model):
        return (batch_plan(model.manifest)
                if self._batching is not None else None)

    def _snapshot(self):
        """The one unlocked read of the live ``(model, signature, plan)``
        triple: a hot swap replaces it whole by one assignment, so a
        caller holds one version's manifest and weights together and
        its version stamp is the one that ran."""
        # elint: disable=EL001 -- one atomic read of a whole triple
        return self._active

    def _publish(self, fresh, plan):
        """Swap ``fresh`` in (under the execution lock; the caller holds
        the reload lock)."""
        with self._lock:
            self.model = fresh
            self._active = (fresh, fresh.manifest["input_signature"], plan)
            self._loaded_dir = fresh.export_dir

    def _warm_buckets(self, model, plan):
        """Run ``predict`` once at every pad bucket, so cuDNN's set-up
        for each batch size happens at load or hot-swap time, before the
        model takes traffic.  Runs on a fresh model before it is
        published, so the warm old version keeps serving meanwhile."""
        if plan is None or not self._batching.warm:
            return
        for bucket in self._batching.pad_buckets:
            try:
                # One lock hold per bucket: live traffic on the old
                # model interleaves between bucket warms.
                with self.timing.timeit("batcher.warmup"), self._lock:
                    # elint: disable=EL006 -- warm-up serializes with traffic
                    model.predict(model.dummy_inputs(bucket))
            except Exception as e:  # noqa: BLE001 - a model whose zero
                # input fails still serves real traffic, cold
                logger.warning("bucket-%d warmup failed for %r: %s",
                               bucket, self.name, e)
                return
        self.timing.bump("batcher.warmed_models")

    def close(self):
        """Stop the batcher's executor thread (pending requests fail
        fast)."""
        if self._batcher is not None:
            self._batcher.close()

    def maybe_reload(self):
        """Swap in a newer complete version, if one has appeared.  On
        the serialized path the scan runs on the calling request thread;
        with batching the caller is the executor (or a metadata request),
        which must not stall behind a load and warm-up, so the work runs
        on a short-lived background thread and publishes when warm."""
        if self.fleet_managed or not self._versioned:
            return
        # elint: disable=EL001 -- fast path; re-checked under _reload_lock
        if time.monotonic() - self._last_scan < self.poll_interval:
            return
        if self._batcher is None:
            self._scan_and_swap()
            return
        thread = self._reload_thread
        if thread is not None and thread.is_alive():
            return
        # Two threads may both start one; _scan_and_swap re-checks the
        # scan clock under the reload lock, so the second does nothing.
        thread = threading.Thread(target=self._scan_and_swap, daemon=True,
                                  name="reload-%s" % self.name)
        self._reload_thread = thread
        thread.start()

    def _scan_and_swap(self):
        """One version scan; on a change, load and warm the fresh model,
        then publish it, all under the reload lock so versions never
        swap out of order."""
        with self._reload_lock:
            now = time.monotonic()
            if now - self._last_scan < self.poll_interval:
                return
            self._last_scan = now
            try:
                resolved = resolve_export_dir(self.export_dir)
                if resolved == self._loaded_dir:
                    return
                fresh = load_servable(resolved, device=self._device)
            except (OSError, ValueError) as e:
                logger.warning("version rescan failed: %s", e)
                return
            plan = self._plan(fresh)
            # elint: disable=EL006 -- warm before publish, in version order
            self._warm_buckets(fresh, plan)
            self._publish(fresh, plan)
        if self._embedding_service is not None:
            self._embedding_service.set_version(_version_of(fresh))
        logger.info("reloaded model %r from %s (version %s)", self.name,
                    fresh.export_dir, fresh.manifest.get("version"))

    # -- fleet hot-swap barrier (serving/fleet.py drives these) ---------

    def serving_version(self):
        """Version of the model serving traffic now."""
        return _version_of(self._snapshot()[0])

    def prepare_version(self, version, rollback=False):
        """Phase 1 of the fleet barrier: load and warm export version
        ``version`` in the background without publishing it.
        Idempotent; returns the fleet-state dict.  ``rollback`` makes a
        version below the serving one load too (the canary rollback)."""
        version = int(version)
        start = False
        with self._reload_lock:
            serving_ok = (self.serving_version() == version if rollback
                          else self.serving_version() >= version)
            already = (
                serving_ok
                or (self._prepared is not None
                    and self._prepared[0] == version)
                or (self._preparing == version
                    and self._prepare_thread is not None
                    and self._prepare_thread.is_alive()))
            if not already:
                self._preparing = version
                self._prepare_error = None
                thread = threading.Thread(
                    target=self._prepare_worker, args=(version,),
                    daemon=True, name="prepare-%s" % self.name)
                self._prepare_thread = thread
                start = True
        if start:
            thread.start()
        return self.fleet_state()

    def _prepare_worker(self, version):
        """Load and warm one pinned version into the prepared slot,
        outside the reload lock (only the slot update takes it)."""
        try:
            fresh = load_servable(
                resolve_export_dir(self.export_dir, version=version),
                device=self._device)
            plan = self._plan(fresh)
            self._warm_buckets(fresh, plan)
        except Exception as e:  # noqa: BLE001 - a bad or missing export
            # surfaces on /fleet/state
            logger.warning("prepare of version %d failed: %s", version, e)
            with self._reload_lock:
                if self._preparing == version:
                    self._prepare_error = "%s: %s" % (type(e).__name__, e)
                    self._preparing = None
            return
        with self._reload_lock:
            if self._preparing == version:
                self._prepared = (version, fresh, plan)
                self._preparing = None

    def commit_version(self, version, rollback=False):
        """Phase 2 of the fleet barrier: publish a prepared version.
        Refuses a version below the serving one (so a coordinator
        healing a rejoined replica never regresses it) unless
        ``rollback`` (the canary rollback), and refuses an unprepared
        one.  Requests admitted before the flip finish on their model."""
        version = int(version)
        with self._reload_lock:
            serving = self.serving_version()
            if serving == version:
                return {"committed": True, "serving": serving}
            if version < serving and not rollback:
                return {"committed": False, "serving": serving,
                        "error": "version %d would regress serving "
                                 "version %d" % (version, serving)}
            if self._prepared is None or self._prepared[0] != version:
                return {"committed": False, "serving": serving,
                        "error": "version %d not prepared" % version}
            if version < serving:
                logger.warning("ROLLBACK commit: model %r serving %d -> %d",
                               self.name, serving, version)
            _, fresh, plan = self._prepared
            self._prepared = None
            self._publish(fresh, plan)
        if self._embedding_service is not None:
            # PS-backed rows never survive a version flip.
            self._embedding_service.set_version(version)
        tracing.event("serving.version_commit", model=self.name,
                      version=version, rollback=bool(rollback))
        logger.info("fleet commit: model %r now serving version %d",
                    self.name, version)
        return {"committed": True, "serving": version}

    def fleet_state(self):
        """What this replica serves, has warm and ready, and is still
        preparing."""
        with self._reload_lock:
            prepared = (self._prepared[0] if self._prepared is not None
                        else None)
            preparing = self._preparing
            error = self._prepare_error
        return {"serving": self.serving_version(), "prepared": prepared,
                "preparing": preparing, "error": error}

    def metadata(self):
        self.maybe_reload()
        model = self._snapshot()[0]
        return {
            "model_version_status": [{
                "version": str(model.manifest.get("version", 0)),
                "state": "AVAILABLE",
            }],
            "metadata": model.manifest,
        }

    # Window of the replica's own recent queue wait in stats().
    RECENT_WINDOW_SECS = 2.0

    def stats(self):
        """/statz payload: live version, batching config, Timing
        counters and summaries, the queue-wait / execute / request
        histograms, the windowed ``queue_wait_recent_ms`` and, with a
        PS-backed service, its cache counters."""
        model = self._snapshot()[0]
        counters = self.timing.counters()
        batches = counters.get("batcher.batches", 0)
        out = {
            "model": self.name,
            "version": model.manifest.get("version", 0),
            "batching": (self._batching.describe()
                         if self._batching is not None else None),
            "counters": counters,
            "timing": self.timing.summary(),
            "mean_batch_occupancy": (
                counters.get("batcher.rows", 0) / batches
                if batches else None),
            "hists": self.timing.histograms(
                names=("batcher.queue_wait", "batcher.execute",
                       "serving.request")),
        }
        recent = self.timing.recent("batcher.queue_wait",
                                    self.RECENT_WINDOW_SECS)
        if recent is not None and recent["count"] > 0:
            out["queue_wait_recent_ms"] = 1e3 * recent["sum"] / recent[
                "count"]
        elif recent is not None:
            out["queue_wait_recent_ms"] = 0.0
        if self._embedding_service is not None:
            out["emb_cache"] = self._embedding_service.stats()
        return out

    def predict(self, body):
        if self._batcher is None:
            # Serialized path: reload checks stay on request threads (the
            # executor makes them between batches otherwise).
            self.maybe_reload()
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        if "instances" in body:
            rows = body["instances"]
        elif "inputs" in body:
            rows = body["inputs"]
        else:
            raise ValueError("body needs 'instances' or 'inputs'")
        model, signature, plan = self._snapshot()
        outputs = self._execute_predict(model, plan,
                                        _marshal(rows, signature))
        # The stamp is the snapshot's: batches never mix models.
        return {"predictions": _jsonable(outputs),
                "model_version": _version_of(model)}

    def _execute_predict(self, model, plan, inputs):
        """The one execution point of both content types: the batcher's
        admission queue, or the execution lock without batching."""
        if self._batcher is not None:
            return self._batcher.predict(model, plan, inputs)
        with self._lock:
            # elint: disable=EL006 -- one predict at a time without batching
            return model.predict(inputs)

    def _lookup_vectors(self, model, table, ids, source):
        """(vectors, source) of a lookup: the PS-backed service for a
        table the export lacks (or on request), else the export's table,
        through the admission queue when batching."""
        if self._embedding_service is not None and (
                source == "ps" or table not in model.embeddings):
            # Network-bound and touching no model state: it runs on the
            # request thread, never queued behind device batches.
            return self._embedding_service.lookup(table, ids), "ps"
        if self._batcher is not None:
            return self._batcher.lookup(model, table, ids), "export"
        return model.lookup_embedding(table, ids), "export"

    def lookup(self, body):
        if self._batcher is None:
            self.maybe_reload()
        model = self._snapshot()[0]
        vectors, source = self._lookup_vectors(
            model, body["table"], np.asarray(body["ids"], np.int64),
            body.get("source"))
        return {"vectors": vectors.tolist(),
                "model_version": _version_of(model), "source": source}

    # -- binary frame surface -------------------------------------------

    @staticmethod
    def _response_wire(frame):
        """``meta.response_wire`` asks for the response payload in a
        reduced-precision wire dtype (bfloat16)."""
        wire = frame.meta.get("response_wire")
        if wire is None:
            return None
        if wire not in tensor_codec.WIRE_DTYPES:
            raise ValueError("response_wire %r not supported (one of %s)"
                             % (wire, list(tensor_codec.WIRE_DTYPES)))
        return wire

    def predict_frame(self, frame):
        """Binary ``:predict``: the frame's tensors (``instances`` for an
        array-input model, one per leaf for a dict-input one) go into the
        same admission queue as JSON requests; returns the encoded
        response frame (kind "predictions", the output tree flattened
        with its spec in meta)."""
        if self._batcher is None:
            self.maybe_reload()
        model, signature, plan = self._snapshot()
        tensors = frame.tensors
        if not tensors:
            raise ValueError("predict frame carries no tensors")
        if is_leaf_signature(signature):
            if set(tensors) != {"instances"}:
                raise ValueError(
                    "array-input model expects exactly one 'instances' "
                    "tensor, got %s" % sorted(tensors))
            inputs = _marshal_leaf(tensors["instances"], signature,
                                   "instances")
        else:
            inputs = _marshal(dict(tensors), signature)
        outputs = self._execute_predict(model, plan, inputs)
        out_tensors, spec = tensor_codec.flatten_tree(outputs, prefix="p")
        return tensor_codec.encode_frame(
            out_tensors, kind="predictions",
            model_version=_version_of(model),
            wire_dtype=self._response_wire(frame), meta={"tree": spec})

    def lookup_frame(self, frame):
        """Binary ``:lookup``: ids as one int64 tensor, the table in
        meta; the vectors come back as one tensor."""
        if self._batcher is None:
            self.maybe_reload()
        model = self._snapshot()[0]
        table = frame.meta.get("table")
        if not table:
            raise ValueError("lookup frame needs meta.table")
        ids = frame.tensors.get("ids")
        if ids is None:
            raise ValueError("lookup frame needs an 'ids' tensor")
        wire = self._response_wire(frame)
        vectors, source = self._lookup_vectors(
            model, table, np.asarray(ids, np.int64), frame.meta.get("source"))
        return tensor_codec.encode_frame(
            {"vectors": vectors}, kind="vectors",
            model_version=_version_of(model), wire_dtype=wire,
            meta={"source": source})


class _HTTPServer(ThreadingHTTPServer):
    # ThreadingHTTPServer listens with a backlog of 5 (the reference's
    # server keeps it): when more clients than that connect at once, the
    # kernel resets the connections its full accept queue could not
    # take.  A batching server exists to take bursts of clients.
    request_queue_size = 128


class DrainController:
    """Graceful-drain state of one serving process: after ``begin``
    (SIGTERM) new requests are refused with 503 + ``Connection: close``
    while every admitted one, whole in-queue batches included, runs to
    its end (``wait_idle``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight = 0
        self._draining = threading.Event()

    @property
    def draining(self):
        return self._draining.is_set()

    def begin(self):
        self._draining.set()

    def admit(self):
        """True: admitted (pair it with ``done()``); False: draining."""
        with self._lock:
            if self._draining.is_set():
                return False
            self._inflight += 1
            return True

    def done(self):
        with self._lock:
            self._inflight -= 1

    def inflight(self):
        with self._lock:
            return self._inflight

    def wait_idle(self, timeout):
        """True once every admitted request finished; False when the
        grace budget ran out first."""
        deadline = time.monotonic() + timeout
        while True:
            if self.inflight() <= 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)


def install_drain_handler(server, endpoints, drain, grace_secs=10.0):
    """Arm SIGTERM for a graceful drain (from the main thread): stop
    admitting, let in-flight batches finish, then stop the HTTP server
    and the batchers' executors."""

    def drain_and_stop():
        logger.info("SIGTERM: draining (%d in flight, grace %.1fs)",
                    drain.inflight(), grace_secs)
        if not drain.wait_idle(grace_secs):
            logger.warning("drain grace expired with %d in flight",
                           drain.inflight())
        server.shutdown()
        # Close the listening socket at once: a late client is refused
        # (retryable elsewhere) instead of left unanswered.
        server.server_close()
        for endpoint in endpoints:
            endpoint.close()

    def on_sigterm(_signum, _frame):
        drain.begin()
        # The wait runs off the signal frame, which must not block.
        threading.Thread(target=drain_and_stop, daemon=True,
                         name="drain").start()

    signal.signal(signal.SIGTERM, on_sigterm)


def build_server(endpoints, port=0, host="127.0.0.1", drain=None):
    """``endpoints``: one ModelEndpoint or a list, each served under its
    own /v1/models/<name> tree.  ``drain``: a :class:`DrainController`;
    one is built when omitted.  It is ``server.drain``."""
    if isinstance(endpoints, ModelEndpoint):
        endpoints = [endpoints]
    by_name = {e.name: e for e in endpoints}
    if len(by_name) != len(endpoints):
        raise ValueError(
            "duplicate model names: %s"
            % sorted(e.name for e in endpoints))
    drain = drain if drain is not None else DrainController()
    get_paths = {}
    # path -> (endpoint, JSON handler, frame handler)
    post_routes = {}
    for name, endpoint in by_name.items():
        base = "/v1/models/%s" % name
        get_paths[base] = endpoint.metadata
        get_paths[base + "/metadata"] = endpoint.metadata
        post_routes[base + ":predict"] = (
            endpoint, endpoint.predict, endpoint.predict_frame)
        post_routes[base + ":lookup"] = (
            endpoint, endpoint.lookup, endpoint.lookup_frame)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive (every reply sets Content-Length), and no
        # Nagle: header block and body go out as one buffered write, so
        # a keep-alive peer's delayed ACK never stalls a reply.
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        wbufsize = -1

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _reply(self, code, payload, close=False):
            self._reply_bytes(code, json.dumps(payload).encode(),
                              "application/json", close)

        def _reply_bytes(self, code, blob, content_type, close=False):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(blob)))
            if close:
                # Keep-alive clients and the router's pool reconnect
                # elsewhere instead of finding a dead socket later.
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(blob)

        def _reply_text(self, code, text, content_type):
            self._reply_bytes(code, text.encode(), content_type)

        def _statz(self):
            out = {"draining": drain.draining,
                   "models": {name: endpoint.stats()
                              for name, endpoint in by_name.items()}}
            slo = slo_mod.slo_section()
            if slo is not None:
                out["slo"] = slo
            return out

        def do_GET(self):
            if self.path == "/healthz":
                # A draining replica fails the probe, so the router stops
                # sending before the socket closes.
                if drain.draining:
                    return self._reply(503, {"status": "draining"},
                                       close=True)
                return self._reply(200, {"status": "ok"})
            if self.path == "/statz":
                return self._reply(200, self._statz())
            if self.path == "/metrics":
                return self._reply_text(
                    200, serving_to_prometheus(self._statz()),
                    "text/plain; version=0.0.4")
            if tracing.is_tracez_path(self.path):
                return self._reply_text(200, tracing.tracez_body(self.path),
                                        "application/json")
            if slo_mod.is_alertz_path(self.path):
                return self._reply_text(200, slo_mod.alertz_body(),
                                        "application/json")
            if tracing.is_profilez_path(self.path):
                # Blocks this request thread only; the executor serves on.
                return self._reply_text(
                    200, tracing.profilez_body(self.path),
                    "application/json")
            if self.path == "/fleet/state":
                return self._reply(200, {
                    "draining": drain.draining,
                    "models": {name: endpoint.fleet_state()
                               for name, endpoint in by_name.items()}})
            handler = get_paths.get(self.path)
            if handler is not None:
                return self._reply(200, handler())
            self._reply(404, {"error": "unknown path %r (models: %s)"
                              % (self.path, sorted(by_name))})

        def do_POST(self):
            if self.headers.get("Transfer-Encoding") or (
                    "Content-Length" not in self.headers):
                # Keep-alive framing depends on Content-Length.
                self.close_connection = True
                return self._reply(
                    411, {"error": "Content-Length required "
                                   "(chunked bodies unsupported)"})
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            # The frame content type takes the binary path; anything
            # else is JSON.  Errors are always JSON.
            binary = tensor_codec.is_frame_content_type(
                self.headers.get("Content-Type"))
            frame = body = None
            if binary:
                try:
                    frame = tensor_codec.decode_frame(raw)
                except tensor_codec.FrameError as e:
                    return self._reply(400, {"error": "bad frame: %s" % e})
            else:
                try:
                    body = json.loads(raw or b"{}")
                except ValueError as e:
                    return self._reply(400, {"error": "bad JSON: %s" % e})
            if not drain.admit():
                return self._reply(503, {"error": "draining"}, close=True)
            try:
                if self.path == "/fleet/prepare":
                    return self._reply(200, {
                        name: endpoint.prepare_version(
                            body["version"],
                            rollback=bool(body.get("rollback")))
                        for name, endpoint in by_name.items()})
                if self.path == "/fleet/commit":
                    return self._reply(200, {
                        name: endpoint.commit_version(
                            body["version"],
                            rollback=bool(body.get("rollback")))
                        for name, endpoint in by_name.items()})
                route = post_routes.get(self.path)
                if route is None:
                    return self._reply(
                        404, {"error": "unknown path %r (models: %s)"
                              % (self.path, sorted(by_name))})
                endpoint, json_fn, frame_fn = route
                # Server-side request latency, response encoding
                # included, for both content types.
                t0 = time.monotonic()
                if binary:
                    blob = frame_fn(frame)
                    content_type = tensor_codec.FRAME_CONTENT_TYPE
                else:
                    blob = json.dumps(json_fn(body)).encode()
                    content_type = "application/json"
                endpoint.timing.observe("serving.request",
                                        time.monotonic() - t0)
                return self._reply_bytes(200, blob, content_type)
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - a model failure
                # answers 500 and the server keeps serving
                logger.exception("request failed")
                self._reply(500, {"error": "%s: %s"
                                  % (type(e).__name__, e)})
            finally:
                drain.done()

    server = _HTTPServer((host, port), Handler)
    server.drain = drain
    return server


def batch_config_from_args(args):
    """CLI flags -> BatchConfig, or None when batching is off
    (``--enable_batching false`` or ``--max_batch_size 1``)."""
    if not args.enable_batching or args.max_batch_size <= 1:
        return None
    buckets = [int(piece) for piece in
               str(args.pad_buckets or "").split(",") if piece.strip()]
    return BatchConfig(
        max_batch_size=args.max_batch_size,
        batch_timeout_ms=args.batch_timeout_ms,
        pad_buckets=buckets or None,
        warm=args.warm_buckets,
    )


def _model_specs(export_dir):
    """``[(name, dir)]`` of the multi-model form ``a=d1,b=d2`` (every
    comma piece ``name=dir``), or None for one export dir."""
    pieces = [p.strip() for p in export_dir.split(",") if p.strip()]
    named = pieces and all(
        p.partition("=")[0].strip() and p.partition("=")[2].strip()
        for p in pieces)
    # One path that merely contains '=' is not a list of models.
    if not named or (len(pieces) == 1
                     and os.path.sep in pieces[0].partition("=")[0]):
        return None
    return [(p.partition("=")[0].strip(), p.partition("=")[2].strip())
            for p in pieces]


def main(argv=None):
    args = build_serving_parser().parse_args(argv)
    tracing.configure_identity("serving", rank=args.port)
    device = os.environ.get("ELASTICDL_TORCH_DEVICE", "cuda")
    use_float32_numerics()
    batching = batch_config_from_args(args)
    models = _model_specs(args.export_dir)
    n_models = len(models) if models else 1
    # PS-backed lookups: one retry-armed PSClient per process, one
    # service per model (its cache is keyed by that model's version);
    # the byte budget splits evenly across models.
    ps_client = None
    if args.ps_addrs:
        from elasticdl_tpu_torch.utils.retry import ps_rpc_policy
        from elasticdl_tpu_torch.worker.ps_client import build_ps_client

        ps_client = build_ps_client(args.ps_addrs, retry=ps_rpc_policy())

    def kwargs():
        service = None
        if ps_client is not None:
            from elasticdl_tpu_torch.serving.embedding_service import (
                PSEmbeddingService,
            )

            service = PSEmbeddingService(
                ps_client,
                cache_bytes=int(args.emb_cache_mb * (1 << 20)) // n_models)
        return dict(
            poll_interval=args.poll_interval, device=device,
            batching=batching, fleet_managed=args.fleet_managed,
            embedding_service=service,
            boot_version=(args.boot_version if args.boot_version >= 0
                          else None))

    if models:
        if args.model_name:
            logger.warning("--model_name %r ignored: the name=dir form "
                           "names each model", args.model_name)
        endpoints = [ModelEndpoint(path, name=name, **kwargs())
                     for name, path in models]
    else:
        endpoints = [ModelEndpoint(args.export_dir, name=args.model_name,
                                   **kwargs())]
    drain = DrainController()
    server = build_server(endpoints, port=args.port, host=args.host,
                          drain=drain)
    # SLO rules from ELASTICDL_SLO_SPEC resolve against the first
    # endpoint's Timing.
    slo_mod.default_watchdog().bind_timing(endpoints[0].timing)
    slo_mod.default_watchdog().arm_from_env()
    install_drain_handler(server, endpoints, drain,
                          grace_secs=args.drain_grace_secs)
    # After the drain hook: SIGTERM dumps the flight recorder, then the
    # drain runs ($ELASTICDL_TRACE_DIR gates the dump).
    tracing.arm_crash_dump()
    logger.info(
        "serving model(s) %s on %s:%d (%s; predict: POST "
        "/v1/models/<name>:predict; batching: %s; fleet_managed: %s; "
        "ps_addrs: %s)", sorted(e.name for e in endpoints), args.host,
        server.server_address[1], endpoints[0]._snapshot()[0].device,
        batching.describe() if batching else "off", args.fleet_managed,
        args.ps_addrs or "-")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for endpoint in endpoints:
            endpoint.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
