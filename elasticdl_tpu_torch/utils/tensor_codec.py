"""The ONE tensor wire codec: TensorPB (gRPC), binary frames (serving +
streaming export), and IndexedSlices helpers.

Parity with elasticdl/python/common/tensor_utils.py:31-122, but
self-describing (dtype/shape in the message, no TF TensorProto) and with
first-class bfloat16 via ml_dtypes — the natural on-wire dtype for TPU
gradients at half the bandwidth of float32.

Wire compression: ``wire_dtype`` on TensorPB decouples the on-wire
encoding from the logical dtype.  ``ndarray_to_pb(a, wire_dtype="bfloat16")``
ships a float32 array as bfloat16 bytes (half the bandwidth);
``pb_to_ndarray`` transparently upcasts back to the logical ``dtype``, so
every decoder — worker and PS alike — keeps accumulating in float32
without knowing the message was compressed.

Binary frames (docs/serving.md "Wire protocol"): the serving data
plane's length-framed tensor protocol, consolidating what used to be
three wire encodings (PS gRPC TensorPB, serving JSON, router-forwarded
JSON) onto one module.  A frame is::

    preamble   16 bytes, little-endian: magic b"EDF1" (4s), header
               length (u32), payload length (u64)
    header     UTF-8 JSON: {"kind", "model_version", "routing_key"?,
               "meta"?, "tensors": [{"name", "dtype", "wire_dtype"?,
               "shape", "offset", "nbytes"}, ...]}
    payload    raw tensor bytes at 8-byte-aligned offsets

Design points, each load-bearing:

 - **Zero-copy receive.**  ``decode_frame`` hands back
   ``np.frombuffer`` views over the payload buffer — no per-element
   Python objects, no row lists, no copies (upcasting a reduced-
   precision ``wire_dtype`` is the one exception, exactly as on the
   TensorPB path).  Views are read-only; consumers that must mutate
   copy explicitly.
 - **Header-first routing.**  Everything a router needs to place the
   request — routing key, model version, kind — lives in the header,
   so ``read_frame_header`` can take a placement decision after
   reading ``16 + header_len`` bytes and forward the payload
   byte-identically without ever decoding a tensor.
 - **bf16 opt-in per frame.**  The same ``wire_dtype`` contract as
   TensorPB: float32 content ships as bfloat16 bytes when asked,
   decoders upcast transparently, everything else rides at its
   logical dtype.
 - **Loud refusal.**  Truncated preambles/headers/payloads, foreign
   magic, lying lengths, out-of-bounds tensor tables — every malformed
   input raises :class:`FrameError` immediately; nothing blocks waiting
   for bytes the sender never framed.
"""

import json
import struct

import numpy as np

try:
    import ml_dtypes

    _EXTRA_DTYPES = {"bfloat16": np.dtype(ml_dtypes.bfloat16)}
except ImportError:  # pragma: no cover
    _EXTRA_DTYPES = {}

from elasticdl_tpu_torch.proto import elastic_pb2 as pb

# Dtypes accepted as reduced-precision wire encodings of float arrays.
WIRE_DTYPES = ("bfloat16", "float16")


def _np_dtype(name):
    if name in _EXTRA_DTYPES:
        return _EXTRA_DTYPES[name]
    return np.dtype(name)


def dtype_name(dtype):
    return np.dtype(dtype).name if np.dtype(dtype).name != "void" else str(dtype)


def _contiguous_bytes(array):
    # tobytes() already copies; only pre-copy when the layout forces it.
    if not array.flags.c_contiguous:
        array = np.ascontiguousarray(array)
    return array.tobytes()


def ndarray_to_pb(array, out=None, wire_dtype=None):
    """Encode an ndarray; ``wire_dtype`` ("bfloat16") downcasts float32
    content on the wire while ``dtype`` keeps naming the logical type the
    decoder must hand back."""
    array = np.asarray(array)
    t = out if out is not None else pb.TensorPB()
    t.dtype = array.dtype.name
    del t.dims[:]
    t.dims.extend(array.shape)
    if (
        wire_dtype
        and wire_dtype in WIRE_DTYPES
        and wire_dtype != array.dtype.name
        and array.dtype == np.float32
    ):
        t.wire_dtype = wire_dtype
        t.content = _contiguous_bytes(array.astype(_np_dtype(wire_dtype)))
    else:
        if t.wire_dtype:
            t.wire_dtype = ""
        t.content = _contiguous_bytes(array)
    return t


def pb_to_ndarray(t):
    """Decode to the LOGICAL dtype: a reduced-precision wire encoding is
    upcast back (e.g. bfloat16 bytes -> float32 array), so accumulation
    downstream always happens at full precision."""
    logical = _np_dtype(t.dtype)
    wire = _np_dtype(t.wire_dtype) if t.wire_dtype else logical
    array = np.frombuffer(t.content, dtype=wire)
    if wire != logical:
        array = array.astype(logical)
    return array.reshape(tuple(t.dims))


def indexed_slices_to_pb(values, ids, out=None, wire_dtype=None):
    s = out if out is not None else pb.IndexedSlicesPB()
    ndarray_to_pb(values, out=s.values, wire_dtype=wire_dtype)
    del s.ids[:]
    s.ids.extend(np.asarray(ids, dtype=np.int64).tolist())
    return s


def pb_to_indexed_slices(s):
    return pb_to_ndarray(s.values), np.asarray(s.ids, dtype=np.int64)


def merge_indexed_slices(values, ids):
    """Deduplicate ids, summing rows that share an id.

    Equivalent of the reference's unsorted_segment_sum merge
    (elasticdl/python/common/tensor_utils.py:44-56).  Runs once per table
    per minibatch, so it avoids the ``np.add.at`` slow path: rows are
    gathered in segment order and summed with ``np.add.reduceat`` over
    ``np.bincount``-derived segment starts.
    """
    ids = np.asarray(ids, dtype=np.int64)
    values = np.asarray(values)
    uniq, inverse = np.unique(ids, return_inverse=True)
    if uniq.size == ids.size:
        # No duplicates (the trainer already pushes unique ids): the
        # merge is a pure gather into sorted-id order — or nothing at
        # all when the ids arrive pre-sorted.
        if ids.size == 0 or np.array_equal(ids, uniq):
            return values, uniq
        return values[np.argsort(ids, kind="stable")], uniq
    order = np.argsort(inverse, kind="stable")
    starts = np.zeros(uniq.size, dtype=np.int64)
    starts[1:] = np.cumsum(np.bincount(inverse, minlength=uniq.size))[:-1]
    merged = np.add.reduceat(values[order], starts, axis=0)
    return merged.astype(values.dtype, copy=False), uniq


def model_to_pb(dense=None, embeddings=None, infos=None, version=0,
                wire_dtype=None):
    """Build a ModelPB from dicts of ndarrays / (values, ids) pairs.

    ``wire_dtype`` compresses every float32 tensor (dense grads and
    embedding rows — ids always stay int64) on the wire."""
    m = pb.ModelPB(version=version)
    for name, arr in (dense or {}).items():
        ndarray_to_pb(
            np.asarray(arr), out=m.dense_parameters[name],
            wire_dtype=wire_dtype,
        )
    for name, (values, ids) in (embeddings or {}).items():
        indexed_slices_to_pb(
            values, ids, out=m.embedding_tables[name],
            wire_dtype=wire_dtype,
        )
    for info in infos or []:
        m.embedding_table_infos.add(
            name=info["name"],
            dim=info["dim"],
            initializer=info.get("initializer", "uniform"),
            dtype=info.get("dtype", "float32"),
        )
    return m


def pb_to_model(m):
    dense = {k: pb_to_ndarray(v) for k, v in m.dense_parameters.items()}
    embeddings = {
        k: pb_to_indexed_slices(v) for k, v in m.embedding_tables.items()
    }
    infos = [
        {
            "name": i.name,
            "dim": i.dim,
            "initializer": i.initializer,
            "dtype": i.dtype,
        }
        for i in m.embedding_table_infos
    ]
    return dense, embeddings, infos, m.version


# -- binary frames (the serving/streaming wire format) --------------------

FRAME_MAGIC = b"EDF1"
_PREAMBLE = struct.Struct("<4sIQ")
FRAME_PREAMBLE_SIZE = _PREAMBLE.size  # 16
# A request header is a routing key + a small tensor table; anything
# bigger is garbage (or an attack), refused before allocation.
FRAME_HEADER_MAX = 4 << 20
FRAME_ALIGN = 8
# The HTTP content type the serving tier negotiates on.  JSON stays the
# compatibility fallback; this is the hot path.
FRAME_CONTENT_TYPE = "application/x-elasticdl-frame"


class FrameError(ValueError):
    """Malformed frame: foreign magic, truncation, a lying length, an
    out-of-bounds tensor table.  Always raised eagerly — a bad frame is
    a loud 4xx, never a hang."""


def is_frame_content_type(content_type):
    """True when an HTTP Content-Type names the frame protocol
    (parameters after ';' ignored)."""
    if not content_type:
        return False
    return (content_type.partition(";")[0].strip().lower()
            == FRAME_CONTENT_TYPE)


def _tensor_items(tensors):
    if isinstance(tensors, dict):
        return list(tensors.items())
    return list(tensors)


def encode_frame(tensors, kind="", model_version=0, routing_key=None,
                 wire_dtype=None, meta=None):
    """Encode named tensors (a dict or [(name, array), ...]; order
    preserved) as one frame.  ``wire_dtype`` ("bfloat16"/"float16")
    compresses float32 tensors on the wire — the TensorPB contract:
    logical dtype recorded, decoder upcasts.  ``meta`` must be
    JSON-able; it rides in the header, so keep it small (the header is
    what a router reads before the payload)."""
    entries = []
    chunks = []
    offset = 0
    for name, arr in _tensor_items(tensors):
        arr = np.asarray(arr)
        logical = dtype_name(arr.dtype)
        use_wire = None
        if (wire_dtype and wire_dtype in WIRE_DTYPES
                and wire_dtype != logical and arr.dtype == np.float32):
            use_wire = wire_dtype
            data = _contiguous_bytes(arr.astype(_np_dtype(use_wire)))
        else:
            data = _contiguous_bytes(arr)
        pad = (-offset) % FRAME_ALIGN
        if pad:
            chunks.append(b"\x00" * pad)
            offset += pad
        entry = {
            "name": str(name),
            "dtype": logical,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": len(data),
        }
        if use_wire:
            entry["wire_dtype"] = use_wire
        entries.append(entry)
        chunks.append(data)
        offset += len(data)
    header = {"kind": str(kind), "model_version": int(model_version),
              "tensors": entries}
    if routing_key is not None:
        header["routing_key"] = str(routing_key)
    if meta is not None:
        header["meta"] = meta
    raw_header = json.dumps(header, separators=(",", ":")).encode()
    if len(raw_header) > FRAME_HEADER_MAX:
        raise FrameError("frame header %d bytes exceeds the %d limit "
                         "(meta too large?)"
                         % (len(raw_header), FRAME_HEADER_MAX))
    return b"".join(
        [_PREAMBLE.pack(FRAME_MAGIC, len(raw_header), offset),
         raw_header] + chunks)


def frame_size(data):
    """Total frame length claimed by the preamble at the head of
    ``data`` (which may hold extra trailing bytes)."""
    header_len, payload_len = _unpack_preamble(data)
    return FRAME_PREAMBLE_SIZE + header_len + payload_len


def _unpack_preamble(data):
    if len(data) < FRAME_PREAMBLE_SIZE:
        raise FrameError(
            "truncated frame: %d bytes, preamble needs %d"
            % (len(data), FRAME_PREAMBLE_SIZE))
    magic, header_len, payload_len = _PREAMBLE.unpack_from(data)
    if magic != FRAME_MAGIC:
        raise FrameError("bad frame magic %r (want %r)"
                         % (bytes(magic), FRAME_MAGIC))
    if header_len > FRAME_HEADER_MAX:
        raise FrameError("frame header length %d exceeds the %d limit"
                         % (header_len, FRAME_HEADER_MAX))
    return header_len, payload_len


def _parse_header(raw_header):
    try:
        header = json.loads(raw_header)
    except ValueError as e:
        raise FrameError("frame header is not valid JSON: %s" % e)
    if not isinstance(header, dict) or not isinstance(
            header.get("tensors"), list):
        raise FrameError("frame header must be a JSON object with a "
                         "'tensors' list")
    return header


def _frame_dtype(name):
    """A dtype a frame may carry: fixed-size numeric/bool kinds plus
    the registered extra dtypes (bfloat16).  Anything else — object,
    strings, datetimes, structured voids — is refused: ``object`` in
    particular resolves via ``np.dtype`` with itemsize 8 but makes
    ``np.frombuffer`` raise a PLAIN ValueError, which would escape the
    FrameError contract and kill the caller's connection instead of
    producing a 400."""
    try:
        dtype = _np_dtype(name)
    except TypeError as e:
        raise FrameError("unknown dtype %r: %s" % (name, e))
    if dtype.kind not in "biufc" and not any(
            dtype == extra for extra in _EXTRA_DTYPES.values()):
        raise FrameError("dtype %r is not a frameable tensor dtype"
                         % (name,))
    return dtype


def _tensor_view(entry, payload):
    """Zero-copy ndarray view of one tensor-table entry over the
    payload buffer (upcast-copy only for reduced-precision wire
    dtypes).  Every field is validated against the payload bounds."""
    if not isinstance(entry, dict):
        raise FrameError("tensor table entry %r is not an object"
                         % (entry,))
    try:
        name = entry["name"]
        shape = tuple(int(d) for d in entry["shape"])
        offset = int(entry["offset"])
        nbytes = int(entry["nbytes"])
        logical = _frame_dtype(entry["dtype"])
        wire = (_frame_dtype(entry["wire_dtype"])
                if entry.get("wire_dtype") else logical)
    except (KeyError, TypeError, ValueError) as e:
        # FrameError IS a ValueError: re-wrapping keeps one loud type.
        raise FrameError("bad tensor table entry %r: %s" % (entry, e))
    if any(d < 0 for d in shape):
        raise FrameError("tensor %r has negative dims %r"
                         % (name, shape))
    count = 1
    for d in shape:
        count *= d
    if nbytes != count * wire.itemsize:
        raise FrameError(
            "tensor %r: %d bytes does not match shape %r of %s"
            % (name, nbytes, shape, wire.name))
    if offset < 0 or offset + nbytes > len(payload):
        raise FrameError(
            "tensor %r: [%d, %d) outside the %d-byte payload"
            % (name, offset, offset + nbytes, len(payload)))
    try:
        arr = np.frombuffer(payload, dtype=wire, count=count,
                            offset=offset)
    except ValueError as e:  # belt over the allowlist: a decode
        # failure is a malformed frame, never a handler-killer
        raise FrameError("tensor %r: %s" % (name, e))
    if wire != logical:
        arr = arr.astype(logical)
    return name, arr.reshape(shape)


class Frame:
    """A decoded frame: header fields + {name: ndarray} views."""

    __slots__ = ("kind", "model_version", "routing_key", "meta",
                 "tensors")

    def __init__(self, kind, model_version, routing_key, meta,
                 tensors):
        self.kind = kind
        self.model_version = model_version
        self.routing_key = routing_key
        self.meta = meta
        self.tensors = tensors


def decode_frame(data):
    """``data`` (bytes/memoryview holding EXACTLY one frame) ->
    :class:`Frame` with zero-copy tensor views.  Raises
    :class:`FrameError` on anything malformed."""
    buf = memoryview(data)
    header_len, payload_len = _unpack_preamble(buf)
    total = FRAME_PREAMBLE_SIZE + header_len + payload_len
    if len(buf) != total:
        raise FrameError(
            "frame length %d does not match the preamble's %d "
            "(truncated or trailing garbage)" % (len(buf), total))
    header = _parse_header(
        bytes(buf[FRAME_PREAMBLE_SIZE:FRAME_PREAMBLE_SIZE
                  + header_len]))
    payload = buf[FRAME_PREAMBLE_SIZE + header_len:]
    tensors = {}
    for entry in header["tensors"]:
        name, view = _tensor_view(entry, payload)
        if name in tensors:
            raise FrameError("duplicate tensor name %r" % name)
        tensors[name] = view
    meta = header.get("meta")
    return Frame(
        kind=str(header.get("kind", "")),
        model_version=int(header.get("model_version", 0) or 0),
        routing_key=header.get("routing_key"),
        meta=meta if isinstance(meta, dict) else {},
        tensors=tensors,
    )


def _read_exact(fp, n, what):
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = fp.read(remaining)
        if not chunk:
            raise FrameError("truncated %s: wanted %d more bytes"
                             % (what, remaining))
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def peek_frame_header(data):
    """Parse ONLY the preamble + JSON header of an in-memory frame —
    no tensor views, no payload touch.  This is the PS servicer's
    fencing read (docs/ps_recovery.md): ``generation`` rides in the
    header's meta, so a push stamped by a dead incarnation is rejected
    BEFORE any payload decode.  The preamble's claimed total is
    cross-checked against ``len(data)`` exactly as in
    :func:`decode_frame`, so a lying length is loud here, not later."""
    buf = memoryview(data)
    header_len, payload_len = _unpack_preamble(buf)
    total = FRAME_PREAMBLE_SIZE + header_len + payload_len
    if len(buf) != total:
        raise FrameError(
            "frame length %d does not match the preamble's %d "
            "(truncated or trailing garbage)" % (len(buf), total))
    return _parse_header(
        bytes(buf[FRAME_PREAMBLE_SIZE:FRAME_PREAMBLE_SIZE
                  + header_len]))


def frame_meta(header):
    """The header's meta dict ({} when absent or not an object) — the
    same coercion :func:`decode_frame` applies."""
    meta = header.get("meta")
    return meta if isinstance(meta, dict) else {}


def read_frame_header(fp, limit=None):
    """Read EXACTLY the preamble + header from a stream and stop —
    the router's keyed-placement read: the routing decision needs the
    header only, the payload is forwarded without being decoded.

    Returns ``(header_dict, raw_prefix_bytes, payload_len)`` where
    ``raw_prefix_bytes`` are the bytes consumed verbatim (so a
    forwarder can splice them back in front of the streamed payload,
    byte-identically).  ``limit`` (e.g. an HTTP Content-Length) is
    cross-checked against the preamble's total so a lying frame can
    never make the caller wait on bytes that will not come."""
    preamble = _read_exact(fp, FRAME_PREAMBLE_SIZE, "frame preamble")
    header_len, payload_len = _unpack_preamble(preamble)
    total = FRAME_PREAMBLE_SIZE + header_len + payload_len
    if limit is not None and total != limit:
        raise FrameError(
            "frame claims %d bytes but the transport framed %d"
            % (total, limit))
    raw_header = _read_exact(fp, header_len, "frame header")
    return (_parse_header(raw_header), preamble + raw_header,
            payload_len)


# -- pytree flatten/unflatten over frame tensors --------------------------
#
# A model's output is an arbitrary pytree of arrays; frames carry flat
# named tensors.  The spec mirrors the tree with tensor NAMES at the
# leaves and rides in the frame's meta, so any consumer can rebuild the
# exact structure without knowing the model.

def flatten_tree(tree, prefix="t"):
    """pytree of arrays -> ([(name, array), ...], spec)."""
    tensors = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, "%s/%s" % (path, k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, "%s/%d" % (path, i))
                    for i, v in enumerate(node)]
        tensors.append((path, np.asarray(node)))
        return path

    spec = walk(tree, prefix)
    return tensors, spec


def unflatten_tree(spec, tensors):
    """Inverse of :func:`flatten_tree` over a {name: array} dict."""
    if isinstance(spec, dict):
        return {k: unflatten_tree(v, tensors) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [unflatten_tree(v, tensors) for v in spec]
    if spec not in tensors:
        raise FrameError("tree spec names missing tensor %r" % (spec,))
    return tensors[spec]


# -- model frames (the streaming export/ingest format) --------------------

MODEL_FRAME_KIND = "model"
_DENSE_PREFIX = "d/"
_EMB_IDS_PREFIX = "ei/"
_EMB_VALS_PREFIX = "ev/"


def encode_model_frame(dense=None, embeddings=None, version=0,
                       wire_dtype=None, meta=None):
    """One whole model snapshot ({name: array} dense + {table: (ids,
    values)} embeddings) as a single frame — the streaming twin of
    ``model_to_pb`` and of an npz export archive.  ``wire_dtype``
    compresses float32 content exactly as on the PS plane (ids always
    stay int64)."""
    tensors = []
    for name, arr in (dense or {}).items():
        tensors.append((_DENSE_PREFIX + name, arr))
    for table, (ids, values) in (embeddings or {}).items():
        tensors.append((_EMB_IDS_PREFIX + table,
                        np.asarray(ids, np.int64)))
        tensors.append((_EMB_VALS_PREFIX + table, values))
    return encode_frame(tensors, kind=MODEL_FRAME_KIND,
                        model_version=version, wire_dtype=wire_dtype,
                        meta=meta)


def decode_model_frame(data):
    """-> (dense, embeddings, version).  Upcasts wire dtypes back to
    their logical types; refuses a frame of any other kind."""
    frame = decode_frame(data)
    if frame.kind != MODEL_FRAME_KIND:
        raise FrameError("not a model frame (kind %r)" % frame.kind)
    dense = {}
    ids = {}
    vals = {}
    for name, arr in frame.tensors.items():
        if name.startswith(_DENSE_PREFIX):
            dense[name[len(_DENSE_PREFIX):]] = arr
        elif name.startswith(_EMB_IDS_PREFIX):
            ids[name[len(_EMB_IDS_PREFIX):]] = arr
        elif name.startswith(_EMB_VALS_PREFIX):
            vals[name[len(_EMB_VALS_PREFIX):]] = arr
        else:
            raise FrameError("model frame tensor %r has no d/ei/ev "
                             "prefix" % name)
    if set(ids) != set(vals):
        raise FrameError("embedding ids/values tables mismatch: %s vs "
                         "%s" % (sorted(ids), sorted(vals)))
    embeddings = {t: (ids[t], vals[t]) for t in ids}
    return dense, embeddings, frame.model_version


# -- PS data-plane frames (docs/ps_pipeline.md "Frame wire") ---------------
#
# The gradient push / dense pull twins of the pb ModelPB path: one frame
# blob per RPC, riding the RawFrame identity codec (proto/rpc.py) so the
# servicer's decode_frame views alias the gRPC message bytes directly.
# The frame header's meta carries what the proto envelope used to —
# generation (so fencing rejects before decode) and the lr override.
# Embedding pairs here use the PS push ordering (values, ids), unlike
# the export-side model frames' (ids, values).

GRADS_FRAME_KIND = "grads"
PARAMS_FRAME_KIND = "params"


def encode_grads_frame(dense=None, embeddings=None, version=0,
                       learning_rate=0.0, generation=0,
                       wire_dtype=None):
    """One shard's gradient push ({name: array} dense + {table:
    (values, ids)} embeddings) as a single frame.  ``wire_dtype``
    compresses float32 content exactly as ``model_to_pb`` does (ids
    always stay int64)."""
    tensors = []
    for name, arr in (dense or {}).items():
        tensors.append((_DENSE_PREFIX + name, arr))
    for table, (values, ids) in (embeddings or {}).items():
        tensors.append((_EMB_VALS_PREFIX + table, values))
        tensors.append((_EMB_IDS_PREFIX + table,
                        np.asarray(ids, np.int64)))
    meta = {"generation": int(generation),
            "learning_rate": float(learning_rate)}
    return encode_frame(tensors, kind=GRADS_FRAME_KIND,
                        model_version=version, wire_dtype=wire_dtype,
                        meta=meta)


def decode_grads_frame(data):
    """-> (dense, {table: (values, ids)}, version, learning_rate).
    Zero-copy views over ``data`` (upcast-copy only for reduced-
    precision wire dtypes); refuses any other frame kind."""
    frame = decode_frame(data)
    if frame.kind != GRADS_FRAME_KIND:
        raise FrameError("not a gradient frame (kind %r)" % frame.kind)
    dense = {}
    ids = {}
    vals = {}
    for name, arr in frame.tensors.items():
        if name.startswith(_DENSE_PREFIX):
            dense[name[len(_DENSE_PREFIX):]] = arr
        elif name.startswith(_EMB_IDS_PREFIX):
            table = name[len(_EMB_IDS_PREFIX):]
            if arr.dtype != np.int64 or arr.ndim != 1:
                raise FrameError(
                    "embedding id tensor %r must be int64 [n], got %s "
                    "%r" % (name, arr.dtype.name, arr.shape))
            ids[table] = arr
        elif name.startswith(_EMB_VALS_PREFIX):
            vals[name[len(_EMB_VALS_PREFIX):]] = arr
        else:
            raise FrameError("gradient frame tensor %r has no d/ei/ev "
                             "prefix" % name)
    if set(ids) != set(vals):
        raise FrameError("embedding ids/values tables mismatch: %s vs "
                         "%s" % (sorted(ids), sorted(vals)))
    for table in ids:
        if vals[table].shape[:1] != ids[table].shape:
            raise FrameError(
                "embedding table %r: %d value rows for %d ids"
                % (table, vals[table].shape[0] if vals[table].ndim
                   else 0, ids[table].size))
    embeddings = {t: (vals[t], ids[t]) for t in ids}
    try:
        learning_rate = float(
            frame.meta.get("learning_rate", 0.0) or 0.0)
    except (TypeError, ValueError):
        raise FrameError("meta learning_rate %r is not a number"
                         % (frame.meta.get("learning_rate"),))
    return dense, embeddings, frame.model_version, learning_rate


def encode_params_frame(dense=None, version=0, initialized=True,
                        generation=0, wire_dtype=None):
    """A dense-parameter pull response as a single frame.  The
    not-modified fast path is simply a frame with no tensors — the
    header (initialized/version/generation in meta) still rides, so
    generation tracking works exactly as on the pb path."""
    tensors = [(_DENSE_PREFIX + name, arr)
               for name, arr in (dense or {}).items()]
    meta = {"initialized": bool(initialized),
            "generation": int(generation)}
    return encode_frame(tensors, kind=PARAMS_FRAME_KIND,
                        model_version=version, wire_dtype=wire_dtype,
                        meta=meta)


def decode_params_frame(data):
    """-> (initialized, version, generation, {name: array})."""
    frame = decode_frame(data)
    if frame.kind != PARAMS_FRAME_KIND:
        raise FrameError("not a params frame (kind %r)" % frame.kind)
    dense = {}
    for name, arr in frame.tensors.items():
        if not name.startswith(_DENSE_PREFIX):
            raise FrameError("params frame tensor %r has no d/ prefix"
                             % name)
        dense[name[len(_DENSE_PREFIX):]] = arr
    try:
        generation = int(frame.meta.get("generation", 0) or 0)
    except (TypeError, ValueError):
        raise FrameError("meta generation %r is not an integer"
                         % (frame.meta.get("generation"),))
    return (bool(frame.meta.get("initialized")), frame.model_version,
            generation, dense)


# -- decode-copy accounting ------------------------------------------------
#
# "Decode-copy bytes" = bytes the CODEC layer copies to turn a received
# message into consumable ndarrays (transport-level costs are identical
# across encodings and excluded).  Computed structurally from shapes so
# the accounting itself never forces an extra materialization.
#
#  - pb: every TensorPB.content access materializes a fresh Python
#    bytes object (one full payload copy), each repeated-int64 id is
#    boxed into a Python int on conversion (8 bytes/id counted, the
#    boxing overhead is free on top), and a reduced-precision
#    wire_dtype pays the upcast allocation.
#  - frame: tensor views alias the wire buffer — only the wire_dtype
#    upcast allocates.  Both paths count the upcast, so the bench's
#    frame-vs-pb ratio at equal wire_dtype is honest.

def pb_decode_copy_bytes(t):
    """Copy bytes :func:`pb_to_ndarray` pays for one TensorPB."""
    count = 1
    for d in t.dims:
        count *= d
    wire = t.wire_dtype or t.dtype
    total = count * _np_dtype(wire).itemsize
    if t.wire_dtype and t.wire_dtype != t.dtype:
        total += count * _np_dtype(t.dtype).itemsize
    return total


def model_pb_decode_copy_bytes(m):
    """Copy bytes :func:`pb_to_model` pays for one ModelPB."""
    total = 0
    for t in m.dense_parameters.values():
        total += pb_decode_copy_bytes(t)
    for s in m.embedding_tables.values():
        total += pb_decode_copy_bytes(s.values) + 8 * len(s.ids)
    return total


def frame_decode_copy_bytes(header):
    """Copy bytes :func:`decode_frame` pays, from a (peeked) header:
    zero per aligned view, the upcast allocation when a tensor rides a
    reduced-precision wire_dtype."""
    total = 0
    for entry in header.get("tensors", ()):
        if not isinstance(entry, dict):
            continue
        wire = entry.get("wire_dtype")
        if not wire or wire == entry.get("dtype"):
            continue
        count = 1
        for d in entry.get("shape", ()):
            count *= int(d)
        total += count * _np_dtype(entry["dtype"]).itemsize
    return total
