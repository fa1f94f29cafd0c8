"""Model server over a servable export: the TF-Serving REST surface
(counterpart of ``elasticdl_tpu/serving/server.py``):

  GET  /v1/models/<name>            -> model metadata (manifest)
  GET  /v1/models/<name>/metadata   -> the same
  GET  /healthz                     -> {"status": "ok"}
  POST /v1/models/<name>:predict    -> {"predictions": [...],
       body {"instances": [...]}        "model_version": v}
       or   {"inputs": [...]}
       or   {"inputs": {name: ...}}  (a dict-input servable, such as a
                                      sampling generation export:
                                      {"prompt": [[ids]], "seed": s})

Errors: 400 for a bad body, 404 for an unknown path, 411 for a POST
without Content-Length, 500 for a failure while running the model.
Responses use HTTP/1.1 keep-alive and TCP_NODELAY.

The model runs on the card unless the caller asks for the CPU
(``ModelEndpoint(..., device="cpu")``; the CLI reads
``ELASTICDL_TORCH_DEVICE``).  The CLI turns TF32 off for the process
(``utils.device.use_float32_numerics``) before it loads the model, so
predictions are computed in float32; a library caller sets the numerics
it wants.  A generation export answers token ids (int32), computed in
its config's dtype.  Predictions are any tree of arrays the model
returns, written as JSON by ``_jsonable``.  Each request runs one
``predict``, serialized by an execution lock; request batching, the
fleet barrier, binary frames, ``:lookup``, drain and SLO surfaces are
not ported yet.

Run: python -m elasticdl_tpu_torch.serving.server --export_dir D [--port P]
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from elasticdl_tpu_torch.serving.loader import (
    is_leaf_signature,
    load_servable,
    resolve_export_dir,
)
from elasticdl_tpu_torch.utils.args import build_serving_parser
from elasticdl_tpu_torch.utils.device import use_float32_numerics
from elasticdl_tpu_torch.utils.logging import get_logger

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
    """JSON inputs -> the ndarray, or flat dict of ndarrays, that the
    manifest's input signature names, each leaf in its dtype and checked
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
    leaves by one ``.tolist()``, numpy scalars by ``.item()``, plain
    scalars and strings as they are, anything else through
    ``np.asarray``."""
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


class ModelEndpoint:
    """One loaded servable plus request/response marshalling.

    When ``export_dir`` is a versioned base (``<base>/<N>/``) the
    endpoint serves the newest complete version and hot-swaps when a
    newer one appears: a request re-scans at most once per
    ``poll_interval`` seconds, loads the new servable outside the
    execution lock and swaps it in under the lock, so in-flight predicts
    finish on the old model."""

    def __init__(self, export_dir, name=None, poll_interval=2.0,
                 device=None):
        self.export_dir = export_dir
        self.poll_interval = poll_interval
        self._device = device
        self.model = load_servable(export_dir, device=device)
        self._versioned = not os.path.isfile(
            os.path.join(export_dir, "manifest.json"))
        self._last_scan = time.monotonic()
        self.name = name or self.model.manifest.get("model_name") or "model"
        self._lock = threading.Lock()         # model execution
        self._reload_lock = threading.Lock()  # scan/load/swap

    def _snapshot(self):
        """The one unlocked read of the live servable.  A hot swap
        replaces it whole by one reference assignment (under the
        execution lock), so a caller holds one version's manifest and
        weights together and its version stamp is the one that ran."""
        # elint: disable=EL001 -- one atomic read of a whole servable
        return self.model

    def maybe_reload(self):
        """Swap in a newer complete version, if one has appeared."""
        if not self._versioned:
            return
        with self._reload_lock:
            now = time.monotonic()
            if now - self._last_scan < self.poll_interval:
                return
            self._last_scan = now
            try:
                resolved = resolve_export_dir(self.export_dir)
                if resolved == self._snapshot().export_dir:
                    return
                fresh = load_servable(resolved, device=self._device)
            except (OSError, ValueError) as e:
                logger.warning("version rescan failed: %s", e)
                return
            with self._lock:
                self.model = fresh
        logger.info("reloaded model %r from %s (version %s)", self.name,
                    fresh.export_dir, fresh.manifest.get("version"))

    def metadata(self):
        self.maybe_reload()
        model = self._snapshot()
        return {
            "model_version_status": [{
                "version": str(model.manifest.get("version", 0)),
                "state": "AVAILABLE",
            }],
            "metadata": model.manifest,
        }

    def predict(self, body):
        self.maybe_reload()
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        if "instances" in body:
            rows = body["instances"]
        elif "inputs" in body:
            rows = body["inputs"]
        else:
            raise ValueError("body needs 'instances' or 'inputs'")
        # Marshal outside the lock against one snapshot of the model; the
        # version stamp below is the snapshot's.
        model = self._snapshot()
        inputs = _marshal(rows, model.manifest["input_signature"])
        # Deliberate: one predict at a time on the one card; concurrent
        # ones would only contend for it (request batching is ROADMAP A12).
        with self._lock:
            # elint: disable=EL006 -- one predict at a time on the card
            outputs = model.predict(inputs)
        return {"predictions": _jsonable(outputs),
                "model_version": int(model.manifest.get("version", 0) or 0)}


def build_server(endpoints, port=0, host="127.0.0.1"):
    """``endpoints``: one ModelEndpoint or a list, each served under its
    own /v1/models/<name> tree."""
    if isinstance(endpoints, ModelEndpoint):
        endpoints = [endpoints]
    by_name = {e.name: e for e in endpoints}
    if len(by_name) != len(endpoints):
        raise ValueError(
            "duplicate model names: %s"
            % sorted(e.name for e in endpoints))
    get_paths = {}
    post_paths = {}
    for name, endpoint in by_name.items():
        base = "/v1/models/%s" % name
        get_paths[base] = endpoint.metadata
        get_paths[base + "/metadata"] = endpoint.metadata
        post_paths[base + ":predict"] = endpoint.predict

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive (every reply sets Content-Length), and no
        # Nagle: header block and body go out as one buffered write, so
        # a keep-alive peer's delayed ACK never stalls a reply.
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        wbufsize = -1

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _unknown(self):
            self._reply(404, {"error": "unknown path %r (models: %s)"
                              % (self.path, sorted(by_name))})

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"status": "ok"})
            handler = get_paths.get(self.path)
            if handler is None:
                return self._unknown()
            self._reply(200, handler())

        def do_POST(self):
            if self.headers.get("Transfer-Encoding") or (
                    "Content-Length" not in self.headers):
                # Keep-alive framing depends on Content-Length.
                self.close_connection = True
                return self._reply(
                    411, {"error": "Content-Length required "
                                   "(chunked bodies unsupported)"})
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            handler = post_paths.get(self.path)
            if handler is None:
                return self._unknown()
            try:
                body = json.loads(raw or b"{}")
            except ValueError as e:
                return self._reply(400, {"error": "bad JSON: %s" % e})
            try:
                return self._reply(200, handler(body))
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - a model failure
                # answers 500 and the server keeps serving
                logger.exception("request failed")
                self._reply(500, {"error": "%s: %s"
                                  % (type(e).__name__, e)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    args = build_serving_parser().parse_args(argv)
    device = os.environ.get("ELASTICDL_TORCH_DEVICE", "cuda")
    use_float32_numerics()
    endpoint = ModelEndpoint(args.export_dir, name=args.model_name,
                             poll_interval=args.poll_interval,
                             device=device)
    server = build_server(endpoint, port=args.port, host=args.host)
    logger.info("serving model %r on %s:%d (%s; predict: POST "
                "/v1/models/<name>:predict)", endpoint.name, args.host,
                server.server_address[1], endpoint._snapshot().device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
