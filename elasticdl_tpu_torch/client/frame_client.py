"""Frame client SDK — the one consumer-side home for the binary wire.

Every surface that speaks the frame protocol (docs/serving.md "Wire
protocol") is served by this one client: serving ``:predict`` and
``:lookup`` (directly or through the router — the router forwards
frame bodies byte-identically), and the aggregation tier's streamed
``POST /ingest``.  Before this module each consumer — the serving
bench, the router passthrough check, ad-hoc scripts — carried its own
``http.client`` + codec dance; now they share one encode/decode path,
one keep-alive pooling discipline, and one error-surfacing contract:

 - a 400 reply (the server's codec refused the frame, or ours refused
   the reply) raises :class:`~elasticdl_tpu_torch.utils.tensor_codec.
   FrameError` — the SAME exception the codec raises locally, so a
   caller's malformed-frame handling is transport-blind;
 - ingest's version-monotone refusal (409) raises
   :class:`StaleVersionError` and its program-cache miss (422) raises
   :class:`ProgramRequiredError` — distinct types because the caller's
   recovery differs (skip vs re-send with the program in-band);
 - anything else raises :class:`FrameClientError` with the status and
   the server's error body.

Keep-alive pooling: connections are CHECKED OUT for the round-trip and
checked back in after — never held under a lock across IO (the repo's
lock discipline, enforced by elastic-lint EL006; this client's own
socket-touching methods are registered in the blocking registry so a
CALLER holding a lock across ``predict``/``lookup``/``ingest`` gets
flagged too).  A pooled connection the server idled out is retried
once on a fresh one — the standard keep-alive race.

One client is thread-safe; per-thread clients avoid pool contention in
tight benchmark loops.
"""

import http.client
import json
import threading

import numpy as np

from elasticdl_tpu_torch.utils import tensor_codec
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.tensor_codec import FrameError

logger = get_logger(__name__)


class FrameClientError(RuntimeError):
    """A non-200 reply from a frame endpoint: carries the HTTP
    ``status`` and the server's error ``message``."""

    def __init__(self, status, message):
        super().__init__("HTTP %d: %s" % (status, message))
        self.status = status
        self.message = message


class StaleVersionError(FrameClientError):
    """Ingest 409: the receiver already ingested this version or a
    newer one (version-monotone stream) — skip, don't retry."""


class ProgramRequiredError(FrameClientError):
    """Ingest 422: the frame's parameter tree is new to the receiver
    and no StableHLO program rode along (a restarted aggregator lost
    its cache) — re-send with ``include_program=True``."""


def encode_predict(inputs, wire_dtype=None, response_wire=None,
                   routing_key=None):
    """Encode a ``:predict`` request frame: an array becomes the
    single ``instances`` tensor (array-input models), a dict one named
    tensor per input leaf.  ``wire_dtype`` compresses the REQUEST
    payload; ``response_wire`` asks the server to compress the reply;
    ``routing_key`` pins the request to a canary cohort slice."""
    if isinstance(inputs, dict):
        tensors = {k: np.asarray(v) for k, v in inputs.items()}
    else:
        tensors = {"instances": np.asarray(inputs)}
    meta = {"response_wire": response_wire} if response_wire else None
    return tensor_codec.encode_frame(
        tensors, kind="predict", wire_dtype=wire_dtype, meta=meta,
        routing_key=routing_key)


def decode_predictions(frame):
    """A ``predictions`` reply frame -> the model's output pytree
    (the flattened tensors reassembled through the tree spec the
    server put in meta)."""
    if frame.kind != "predictions":
        raise FrameError("not a predictions frame (kind %r)"
                         % frame.kind)
    return tensor_codec.unflatten_tree(frame.meta.get("tree"),
                                       frame.tensors)


class FrameClient:
    """One frame-speaking peer (serving replica, router, or
    aggregator ingest endpoint) at ``addr`` ("host:port")."""

    def __init__(self, addr, timeout=30.0, pool_size=8):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError("addr must be host:port, got %r"
                             % (addr,))
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self._pool_lock = threading.Lock()
        self._pool = []
        self._pool_size = int(pool_size)

    # -- connection pooling --------------------------------------------

    def _connect(self):
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _checkout(self):
        """(connection, reused): a parked keep-alive connection when
        one is available, else a fresh dial."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return self._connect(), False

    def _checkin(self, conn):
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def close(self):
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    # -- transport -----------------------------------------------------

    def roundtrip(self, path, body,
                  content_type=tensor_codec.FRAME_CONTENT_TYPE):
        """POST ``body`` to ``path`` over a pooled connection; returns
        (status, reply content type, reply bytes).  The low-level
        surface for byte-level consumers (the router-passthrough
        identity check); typed callers use predict/lookup/ingest.  A
        REUSED connection that fails before a reply is retried once on
        a fresh dial — the server idling out a parked connection must
        not surface as a request failure."""
        conn, reused = self._checkout()
        headers = {"Content-Type": content_type}
        for attempt in (0, 1):
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException):
                conn.close()
                if not reused or attempt:
                    raise
                conn, reused = self._connect(), False
                continue
            if resp.getheader("Connection", "").lower() == "close":
                conn.close()  # a draining replica said goodbye
            else:
                self._checkin(conn)
            return resp.status, resp.getheader("Content-Type") or "", \
                raw
        raise AssertionError("unreachable")

    @staticmethod
    def _error(status, raw):
        """Map an error reply to the surfaced exception type."""
        try:
            body = json.loads(raw.decode() or "{}")
            message = body.get("error") or json.dumps(body)
        except (ValueError, UnicodeDecodeError):
            message = repr(raw[:200])
        if status == 400:
            # The peer's codec refused the frame: surface it as the
            # SAME exception a local decode raises.
            return FrameError(message)
        if status == 409:
            return StaleVersionError(status, message)
        if status == 422:
            return ProgramRequiredError(status, message)
        return FrameClientError(status, message)

    def _frame_call(self, path, blob):
        status, ctype, raw = self.roundtrip(path, blob)
        if status != 200:
            raise self._error(status, raw)
        if not tensor_codec.is_frame_content_type(ctype):
            raise FrameClientError(
                status, "expected a frame reply, got %r" % (ctype,))
        return tensor_codec.decode_frame(raw)

    # -- serving data plane --------------------------------------------

    def predict_frame(self, model, blob):
        """POST a pre-encoded ``:predict`` frame; returns the decoded
        reply :class:`~elasticdl_tpu_torch.utils.tensor_codec.Frame`.  The
        encode-once/replay surface (benchmarks, replayed corpora);
        :meth:`predict` is the typed wrapper."""
        return self._frame_call("/v1/models/%s:predict" % model, blob)

    def predict(self, model, inputs, wire_dtype=None,
                response_wire=None, routing_key=None):
        """One prediction round-trip: pytree of inputs in, the model's
        output pytree back (typed ndarrays, no JSON row lists)."""
        frame = self.predict_frame(
            model, encode_predict(inputs, wire_dtype=wire_dtype,
                                  response_wire=response_wire,
                                  routing_key=routing_key))
        return decode_predictions(frame)

    def lookup(self, model, table, ids, source=None,
               response_wire=None):
        """Embedding lookup: int64 ids in, ``[n, dim]`` float32 rows
        back in input order.  ``source="ps"`` forces the PS-backed
        live-table path on a replica that serves both."""
        meta = {"table": table}
        if source:
            meta["source"] = source
        if response_wire:
            meta["response_wire"] = response_wire
        blob = tensor_codec.encode_frame(
            {"ids": np.asarray(ids, np.int64)}, kind="lookup",
            meta=meta)
        frame = self._frame_call("/v1/models/%s:lookup" % model, blob)
        vectors = frame.tensors.get("vectors")
        if vectors is None:
            raise FrameError("lookup reply carries no 'vectors' "
                             "tensor")
        return vectors

    # -- aggregation ingest --------------------------------------------

    def ingest(self, blob):
        """Stream one servable frame (``ContinuousExporter.
        frame_bytes`` / ``servable_frame_bytes``) into an aggregator's
        ``POST /ingest``; returns the ingested version.  Raises
        :class:`StaleVersionError` (409), :class:`ProgramRequiredError`
        (422), or :class:`FrameError` (400) per the endpoint's status
        contract (docs/serving.md "Streamed ingest")."""
        status, _ctype, raw = self.roundtrip("/ingest", blob)
        if status != 200:
            raise self._error(status, raw)
        try:
            return int(json.loads(raw.decode()).get("ingested", 0))
        except (ValueError, UnicodeDecodeError, AttributeError):
            raise FrameClientError(
                status, "malformed ingest reply %r" % raw[:100])
