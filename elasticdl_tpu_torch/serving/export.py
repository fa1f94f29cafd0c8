"""Servable export (counterpart of ``elasticdl_tpu/serving/export.py``).

Export layout (format ``elasticdl_tpu_torch_servable_v1``)::

    export_dir/
      manifest.json   format tag, model name/version, input and output
                      signatures, ``polymorphic_batch``, parameter and
                      embedding-table names, ``platforms``, the program
                      file (``"program": "model.pt2"``) and, where the
                      export came from the zoo, the zoo entry that
                      rebuilds the module: {"module": ...,
                      "model_params": ...}
      model.npz       {slash/joined/name: ndarray} in the JAX package's
                      flat names and layouts (``params_to_jax``), and
                      the tables as ``emb_ids/<t>`` / ``emb_vals/<t>``
      model.pt2       the servable program: an uncompressed zip of two
                      ``torch.export`` archives, layout.pt2
                      (flat_params -> state) and forward.pt2
                      (state, inputs -> outputs)

The program is the counterpart of the reference's StableHLO, and holds
no weights.  Its layout half is ``spec.params_from_jax``: it takes the
weights in the same flat names and layouts as ``model.npz`` and returns
the module's state (OIHW channels-last conv kernels, ``[out, in]``
dense kernels, ...); the loader runs it once per loaded version.  Its
forward half runs the module through ``torch.func.functional_call`` on
that state and is what every request runs.  A continuous exporter
traces both once and ships weights and a manifest on every later
version, and the aggregation tier reuses them.  The GroupNorm and flash
attention kernels are custom ops (``ops/``), so running the forward on
the card launches them.  The loader (``serving/loader.py``) runs the
program without the port's model zoo.

A generation export (``generate=``) carries no program: its loader
rebuilds the module from the zoo entry and runs ``generate_fn`` (one
captured generation program is ROADMAP A12a).  Exports written before
the program existed load the same way.

Carriers and encodings, as in the reference, with its feature prefixes
on the format tag: ``int8-weights+`` (weights-only per-channel int8,
``q8/<name>`` + ``q8scale/<name>``), ``int8-emb+`` (int8 tables), and
``frame+`` (a ``ContinuousExporter`` with ``wire_format="frame"``: the
payload is one binary ``model.frame``, read by the aggregation tier and
refused by the serving loader).  The payload codec is numpy and writes
the reference's bytes.
"""

import copy
import io
import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from elasticdl_tpu_torch.utils import tensor_codec
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.pytree import tree_leaves, tree_map

logger = get_logger(__name__)

FORMAT = "elasticdl_tpu_torch_servable_v1"
PROGRAM_FILE = "model.pt2"
# The two programs inside it (``program_archives``).
LAYOUT_PROGRAM = "layout.pt2"
FORWARD_PROGRAM = "forward.pt2"
# Where the program has been loaded and run: written on either device
# and loaded on the other (tests/test_torch_export_program.py on the
# CPU, chip_smoke.py phase 24 on the card).
PLATFORMS = ("cpu", "cuda")
# torch.export's tracing and (de)serialization keep process-wide state
# (one deserializer at a time): a fleet replica may load a version on
# its prepare thread while another loads or an exporter traces.
PROGRAM_LOCK = threading.RLock()


def _quantize_rows(arr):
    """Per-last-axis symmetric int8: (q, scale) — the ONE quantize
    core shared by the dense and embedding paths."""
    scale = np.maximum(
        np.abs(arr).max(axis=-1, keepdims=True) / 127.0, 1e-12
    ).astype(np.float32)
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q, scale


QUANTIZE_MIN_ELEMS = 4096


def _quantize_int8(flat, min_elems=QUANTIZE_MIN_ELEMS):
    """Weights-only per-channel symmetric int8 for large float arrays.

    Returns ({name: payload_arrays}, [quantized names]).  Each
    quantized W becomes ``q8/<name>`` (int8) + ``q8scale/<name>``
    (float32 per-last-axis-channel scales); small arrays and non-float
    arrays ride through unchanged.  The program still takes float32:
    the loader dequantizes at load time, so this trades a small load
    cost and ~0.4% weight rounding error for a ~4x smaller artifact.
    """
    payload = {}
    quantized = []
    for name, arr in flat.items():
        arr = np.asarray(arr)
        # float32 only: the program was traced with the original dtypes
        # and the loader dequantizes to float32.
        if arr.ndim < 2 or arr.size < min_elems or (
            arr.dtype != np.float32
        ):
            payload[name] = arr
            continue
        q, scale = _quantize_rows(arr)
        payload["q8/" + name] = q
        payload["q8scale/" + name] = scale
        quantized.append(name)
    return payload, quantized


def decode_payload(payload):
    """{npz-layout key: ndarray} -> (dense, embeddings), dequantizing
    every encoding this package writes.  The one payload decoder behind
    both carriers, the npz archive and the binary servable frame
    (``servable_from_frame``)."""
    dense = {}
    embeddings = {}
    for key, value in payload.items():
        if key.startswith("emb_ids/"):
            name = key[len("emb_ids/"):]
            if "emb_vals/" + name in payload:
                values = payload["emb_vals/" + name]
            else:  # int8-quantized table
                values = (payload["q8emb/" + name].astype(np.float32)
                          * payload["q8embscale/" + name])
            embeddings[name] = (value, values)
        elif key.startswith("q8/"):
            name = key[len("q8/"):]
            dense[name] = (value.astype(np.float32)
                           * payload["q8scale/" + name])
        elif not key.startswith(("emb_vals/", "q8scale/",
                                 "q8emb/", "q8embscale/")):
            dense[key] = value
    return dense, embeddings


def load_payload(export_dir):
    """(dense, embeddings) from an export dir: its ``model.npz`` or its
    binary ``model.frame`` (the streaming carrier, decoded as views over
    one file read), int8 encodings dequantized.  Either package's export
    reads the same."""
    npz_path = os.path.join(export_dir, "model.npz")
    if os.path.isfile(npz_path):
        with np.load(npz_path) as z:
            return decode_payload({key: z[key] for key in z.files})
    frame_path = os.path.join(export_dir, "model.frame")
    with open(frame_path, "rb") as f:
        dense, embeddings, _manifest, _program = servable_from_frame(
            f.read())
    return dense, embeddings


def _fsync_dir(path):
    dirfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def publish_export(export_dir, files):
    """Atomically materialize ``files`` ({name: bytes}) as ``export_dir``.

    Stage into a ``<dir>.tmp-<pid>`` sibling, fsync every file and the
    staged dir, ``os.rename`` into place and fsync the parent: a crash at
    any instant leaves either no version dir or a complete one, never a
    torn one.  An existing non-empty ``export_dir`` is swapped out whole
    (old renamed aside to ``<dir>.old-<pid>``, fresh renamed in, old
    removed); that swap is not single-rename atomic, so versioned
    publishers never re-publish a complete ``<base>/<N>/``.
    """
    export_dir = os.path.normpath(export_dir)
    parent = os.path.dirname(export_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = "%s.tmp-%d" % (export_dir, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        for name, blob in files.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        try:
            os.rename(tmp, export_dir)
        except OSError:
            # Destination exists and is non-empty: swap it out whole.
            old = "%s.old-%d" % (export_dir, os.getpid())
            shutil.rmtree(old, ignore_errors=True)
            os.rename(export_dir, old)
            os.rename(tmp, export_dir)
            shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _npz_bytes(payload):
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


# -- binary servable frames (the streaming export/ingest format) ----------

SERVABLE_FRAME_KIND = "servable"
_PROGRAM_TENSOR = "__program__"


def servable_frame_bytes(payload, manifest, program=None):
    """One servable snapshot as a single binary frame
    (``utils/tensor_codec``): the npz payload layout rides as named
    tensors, the manifest in the frame header's meta, and, when the
    parameter tree is new to the receiver, the ``program`` bytes as a
    uint8 tensor.  The streaming twin of an export directory."""
    tensors = list(payload.items())
    if program is not None:
        tensors.append((_PROGRAM_TENSOR,
                        np.frombuffer(program, np.uint8)))
    return tensor_codec.encode_frame(
        tensors, kind=SERVABLE_FRAME_KIND,
        model_version=int(manifest.get("version", 0) or 0),
        meta={"manifest": manifest})


def servable_from_frame(data):
    """-> (dense, embeddings, manifest, program_bytes_or_None).
    Refuses any other frame kind or a frame without a manifest with
    :class:`tensor_codec.FrameError`."""
    frame = tensor_codec.decode_frame(data)
    if frame.kind != SERVABLE_FRAME_KIND:
        raise tensor_codec.FrameError(
            "not a servable frame (kind %r)" % frame.kind)
    manifest = frame.meta.get("manifest")
    if not isinstance(manifest, dict):
        raise tensor_codec.FrameError(
            "servable frame carries no manifest")
    payload = dict(frame.tensors)
    program = payload.pop(_PROGRAM_TENSOR, None)
    if program is not None:
        program = program.tobytes()
    dense, embeddings = decode_payload(payload)
    return dense, embeddings, manifest, program


def _encode_embeddings(payload, embeddings, quantize):
    """Add embedding tables to a payload dict; returns (table names,
    emb-quantized manifest entries).  The one embedding encoder: the
    full export and the ContinuousExporter's program-reuse path write
    the same encodings.  ``emb_quantized`` stays separate from the
    dense list: each format prefix reflects exactly the encodings
    present in the file."""
    table_names = []
    emb_quantized = []
    for name, (ids, values) in (embeddings or {}).items():
        payload["emb_ids/" + name] = ids
        values = np.asarray(values)
        if quantize == "int8" and values.ndim == 2 and (
            values.dtype == np.float32
            and values.size >= QUANTIZE_MIN_ELEMS
        ):
            # Per-row symmetric int8 (rows are the channels).
            q, scale = _quantize_rows(values)
            payload["q8emb/" + name] = q
            payload["q8embscale/" + name] = scale
            emb_quantized.append("emb:" + name)
        else:
            payload["emb_vals/" + name] = values
        table_names.append(name)
    return table_names, emb_quantized


# -- the servable program ----------------------------------------------------


class ServingFunction:
    """What a servable program computes: ``spec.apply_fn(module, inputs,
    train=False)`` with the module's weights taken from
    ``spec.params_from_jax(flat_params)``.  The counterpart of the
    reference's ``lambda p, x: apply_fn(p, x, False)``.

    It keeps a copy of ``module`` whose parameters and buffers are on
    the ``meta`` device (the copy costs no memory and reads no weight),
    so a trace on the exporter's writer thread never touches the module
    the trainer keeps updating.  ``zoo``: ``(module name,
    model_params)`` of the zoo entry, recorded in the manifest when
    known."""

    def __init__(self, spec, module, zoo=None):
        self.spec = spec
        self.zoo = zoo
        memo = {}
        for p in module.parameters():
            memo[id(p)] = torch.nn.Parameter(
                torch.empty_like(p, device="meta"),
                requires_grad=p.requires_grad)
        for b in module.buffers():
            memo[id(b)] = torch.empty_like(b, device="meta")
        self.module = copy.deepcopy(module, memo)
        self.state_names = set(module.state_dict())


class _Apply(torch.nn.Module):
    def __init__(self, serve):
        super().__init__()
        self.model = serve.module
        self._apply_fn = serve.spec.apply_fn

    def forward(self, inputs):
        return self._apply_fn(self.model, inputs, False)


class _Layout(torch.nn.Module):
    """layout(flat_params) -> the module's state: ``spec.params_from_jax``
    as a program, which the loader runs once per loaded version."""

    def __init__(self, serve):
        super().__init__()
        self._params_from_jax = serve.spec.params_from_jax

    def forward(self, flat_params):
        return self._params_from_jax(flat_params)


class _Forward(torch.nn.Module):
    """forward(state, inputs) over the module's own names and layouts.
    The model is held outside the module's registry, so the exported
    program lifts none of its weights; every one of them comes in
    through ``state``."""

    def __init__(self, serve):
        super().__init__()
        self._held = (_Apply(serve),)

    def forward(self, state, inputs):
        return torch.func.functional_call(
            self._held[0], {"model." + k: v for k, v in state.items()},
            (inputs,))


def _grow_batch(a):
    """The example with at least 2 rows: a dimension traced at 1 is
    specialised to 1."""
    a = np.asarray(a)
    if a.ndim >= 1 and a.shape[0] < 2:
        rows = a if a.shape[0] else np.zeros((1,) + a.shape[1:], a.dtype)
        a = np.concatenate([rows, rows])
    return a


def _signature(tree, poly):
    """Input tree -> {shape, dtype} skeleton; with ``poly`` each leaf's
    leading dim is None (a rank-0 leaf keeps its empty shape)."""

    def leaf(a):
        a = np.asarray(a)
        shape = list(a.shape)
        if shape and poly:
            shape[0] = None
        return {"shape": shape, "dtype": str(a.dtype)}

    return tree_map(leaf, tree)


def _uniform_lead(example_input, polymorphic_batch):
    """The reference's rule: the batch dim is free only when every input
    leaf of rank >= 1 shares one leading dim; an export whose leaves
    disagree keeps the example's fixed shapes."""
    leads = {np.shape(leaf)[0] for leaf in tree_leaves(example_input)
             if np.ndim(leaf) >= 1}
    if polymorphic_batch and len(leads) != 1:
        logger.info("input leading dims %s are not uniform; exporting "
                    "with fixed shapes", sorted(leads))
        return False
    return bool(polymorphic_batch)


def _out_signature(ep):
    """The output tree's {shape, dtype} from the program's avals: None
    where a dim is symbolic (it follows the batch).  The serving batcher
    reads it to slice a padded batch back per request."""
    from torch.utils import _pytree

    (output,) = [n for n in ep.graph.nodes if n.op == "output"]
    vals = [node.meta["val"] for node in output.args[0]]
    leaves = [{"shape": [d if isinstance(d, int) else None
                         for d in v.shape],
               "dtype": str(v.dtype).replace("torch.", "")} for v in vals]
    tree = _pytree.tree_unflatten(leaves, ep.call_spec.out_spec)

    def plain(t):
        if isinstance(t, dict) and set(t) != {"shape", "dtype"}:
            return {k: plain(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [plain(v) for v in t]
        return t

    return plain(tree)


def _ep_bytes(ep):
    """One program serialized without its example inputs."""
    try:
        ep.example_inputs = None
    except (AttributeError, ValueError):
        ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _program_bytes(layout, forward):
    """The two programs as one file: an uncompressed zip of their
    ``torch.export`` archives, dated 1980 so that two traces of one
    tree write the same bytes."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for name, ep in ((LAYOUT_PROGRAM, layout),
                         (FORWARD_PROGRAM, forward)):
            z.writestr(zipfile.ZipInfo(name, (1980, 1, 1, 0, 0, 0)),
                       _ep_bytes(ep))
    return buf.getvalue()


def program_archives(blob):
    """A program file's bytes -> {``LAYOUT_PROGRAM``: bytes,
    ``FORWARD_PROGRAM``: bytes}, each a ``torch.export`` archive."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {name: z.read(name)
                for name in (LAYOUT_PROGRAM, FORWARD_PROGRAM)}


def _torch_dtype(arr):
    return torch.from_numpy(np.zeros(0, np.asarray(arr).dtype)).dtype


def trace_servable(serve, flat, example_input, polymorphic_batch=True):
    """Trace and serialize the serving programs of ``serve`` (a
    :class:`ServingFunction`) for a flat parameter dict (``{JAX name:
    ndarray}``).  Returns ``(program_bytes, poly, input_signature,
    output_signature)``: everything about an export that depends on the
    model function and shapes, none of it on the weight values.  Shared
    by :func:`export_servable` and :class:`ContinuousExporter` (which
    caches it across versions).

    The example weights and inputs are fake tensors: they hold no
    memory, and their strides are the ones the programs see when they
    run (the flat weights contiguous, the state as ``params_from_jax``
    lays it out).  They are CPU tensors whatever the module's device:
    the programs are device-neutral (the loader moves them to its
    device), and on a CUDA fake tensor torch 2.11 reports a convolution's
    output as contiguous NCHW where the card's is channels-last, which
    would mislead every stride-dependent step of the trace.

    With ``polymorphic_batch`` the leading dim of every input leaf of
    rank >= 1 is a ``torch.export.Dim``, traced from an example of at
    least 2 rows; when that export fails, the example's fixed shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    poly = _uniform_lead(example_input, polymorphic_batch)

    def fake(a):
        return torch.empty(np.shape(a), dtype=_torch_dtype(a))

    with PROGRAM_LOCK, torch.no_grad():
        with FakeTensorMode(shape_env=ShapeEnv(tracked_fakes=[])):
            flat_t = {name: fake(flat[name]) for name in sorted(flat)}
            state = serve.spec.params_from_jax(flat_t)
            grown = tree_map(lambda a: fake(_grow_batch(a)), example_input)
            fixed = tree_map(fake, example_input)
        if set(state) != serve.state_names:
            raise ValueError(
                "the flat parameters map to %d of the module's %d tensors "
                "(missing %s)" % (
                    len(state), len(serve.state_names),
                    sorted(serve.state_names - set(state))[:5]))
        layout = torch.export.export(_Layout(serve), (flat_t,),
                                     strict=False)
        forward = None
        if poly:
            batch = torch.export.Dim("batch", min=1, max=1 << 20)
            try:
                forward = torch.export.export(
                    _Forward(serve), (state, grown), dynamic_shapes=(
                        {name: None for name in state},
                        tree_map(lambda t: {0: batch} if t.dim() else None,
                                 grown)), strict=False)
            except Exception as e:  # noqa: BLE001 — any trace failure
                logger.warning(
                    "polymorphic-batch export failed (%s); falling back "
                    "to the example's fixed shapes", e)
                poly = False
        if forward is None:
            forward = torch.export.export(_Forward(serve), (state, fixed),
                                          strict=False)
        for ep in (layout, forward):
            if ep.state_dict or ep.constants:
                raise RuntimeError(
                    "the servable program holds tensors: %s" % sorted(
                        list(ep.state_dict) + list(ep.constants))[:5])
        return (_program_bytes(layout, forward), poly,
                _signature(example_input, poly), _out_signature(forward))


def _manifest_for(model_name, version, flat, table_names, quantized,
                  emb_quantized, poly, signature, output_signature,
                  zoo=None, program=True):
    """A truthful manifest from what was actually written.  A quantized
    export gets prefixed format tags, so a loader that predates an
    encoding refuses it at load time; int8 tables get their own
    prefix."""
    fmt = FORMAT
    if quantized:
        fmt = "int8-weights+" + fmt
    if emb_quantized:
        fmt = "int8-emb+" + fmt
    manifest = {
        "format": fmt,
        "model_name": model_name,
        "version": version,
        "quantized_int8": sorted(quantized + emb_quantized),
        "polymorphic_batch": poly,
        "platforms": list(PLATFORMS) if program else [],
        "parameters": sorted(flat),
        "embedding_tables": sorted(table_names),
        "input_signature": signature,
        "output_signature": output_signature,
        "loader": "elasticdl_tpu_torch.serving.loader:load_servable",
    }
    if program:
        manifest["program"] = PROGRAM_FILE
    if zoo is not None:
        manifest["zoo"] = {"module": zoo[0], "model_params": zoo[1]}
    return manifest


def _encode(flat, embeddings, quantize):
    """(payload, quantized dense names, table names, int8 tables)."""
    quantized = []
    if quantize == "int8":
        payload, quantized = _quantize_int8(flat)
    elif quantize:
        raise ValueError("unknown quantize mode %r (only 'int8')"
                         % (quantize,))
    else:
        payload = dict(flat)
    table_names, emb_quantized = _encode_embeddings(
        payload, embeddings, quantize)
    return payload, quantized, table_names, emb_quantized


def _with_overrides(flat, dense_overrides):
    flat = dict(flat)
    for name, value in (dense_overrides or {}).items():
        if name in flat and np.shape(value) == np.shape(flat[name]):
            flat[name] = np.asarray(value, np.asarray(flat[name]).dtype)
    return flat


def write_servable(export_dir, serve, params, example_input, model_name="",
                   version=0, embeddings=None, dense_overrides=None,
                   polymorphic_batch=True, quantize=None):
    """Write a servable export with its program (the reference's
    ``export_servable(export_dir, apply_fn, params, example_input,
    ...)``).  ``serve``: a :class:`ServingFunction`; ``params``:
    ``{JAX name: ndarray}``; ``example_input``: an array or a tree of
    them fixing the signature (values ignored).  ``embeddings``:
    ``{table: (ids, values)}`` (the PS checkpoint merge);
    ``dense_overrides``: ``{name: ndarray}`` taking precedence over
    ``params`` where name and shape match.  ``quantize="int8"``:
    weights-only int8 storage, dequantized by the loader.  Returns the
    manifest."""
    flat = _with_overrides(params, dense_overrides)
    program, poly, signature, output_signature = trace_servable(
        serve, flat, example_input, polymorphic_batch=polymorphic_batch)
    payload, quantized, table_names, emb_quantized = _encode(
        flat, embeddings, quantize)
    manifest = _manifest_for(
        model_name, version, flat, table_names, quantized, emb_quantized,
        poly, signature, output_signature, zoo=serve.zoo)
    publish_export(export_dir, {
        "model.npz": _npz_bytes(payload),
        PROGRAM_FILE: program,
        "manifest.json": json.dumps(manifest, indent=2).encode(),
    })
    logger.info("servable export at %s (%d tensors, %d tables)",
                export_dir, len(flat), len(table_names))
    return manifest


def export_servable(export_dir, spec_name, model_params, module,
                    example_input, model_name="", version=0,
                    generate=None, embeddings=None, polymorphic_batch=True,
                    dense_overrides=None, quantize=None):
    """Write a servable export of ``module``, the zoo entry
    ``load_model_spec(spec_name, model_params)``.

    ``example_input``: an ndarray, or a tree of them, fixing the serving
    signature (the JAX package's ``{shape, dtype}`` per leaf).  With
    ``polymorphic_batch`` the leading dim of every input leaf is free
    when those leaves share one leading dim; the manifest's
    ``polymorphic_batch`` says which, and the serving batcher batches
    only a polymorphic export.  ``embeddings``, ``dense_overrides`` and
    ``quantize``: as :func:`write_servable`.  The export carries the
    program, but a generation export (``generate``: ``prompt_len``,
    ``max_new_tokens``, ``temperature``, recorded as the manifest's
    ``"generate"`` block), which carries the zoo entry alone: the loader
    rebuilds the module and runs its ``generate_fn``.  Returns the
    manifest."""
    from elasticdl_tpu_torch.models.spec import load_model_spec

    spec = load_model_spec(spec_name, model_params)
    flat = spec.params_to_jax(module)
    zoo = (spec_name, model_params)
    if generate is None:
        return write_servable(
            export_dir, ServingFunction(spec, module, zoo=zoo), flat,
            example_input, model_name=model_name, version=version,
            embeddings=embeddings, dense_overrides=dense_overrides,
            polymorphic_batch=polymorphic_batch, quantize=quantize)
    flat = _with_overrides(flat, dense_overrides)
    poly = _uniform_lead(example_input, polymorphic_batch)
    # Prompt + generated ids, int32, one row per prompt.
    prompt = (example_input["prompt"] if isinstance(example_input, dict)
              else example_input)
    output_signature = {
        "shape": [None if poly else int(np.shape(prompt)[0]),
                  int(generate["prompt_len"])
                  + int(generate["max_new_tokens"])],
        "dtype": "int32"}
    payload, quantized, table_names, emb_quantized = _encode(
        flat, embeddings, quantize)
    manifest = _manifest_for(
        model_name, version, flat, table_names, quantized, emb_quantized,
        poly, _signature(example_input, poly), output_signature, zoo=zoo,
        program=False)
    manifest["generate"] = dict(generate)
    publish_export(export_dir, {
        "model.npz": _npz_bytes(payload),
        "manifest.json": json.dumps(manifest, indent=2).encode(),
    })
    logger.info("servable export at %s (%d tensors, %d tables, zoo "
                "route)", export_dir, len(flat), len(table_names))
    return manifest


class ContinuousExporter:
    """Checkpoint-cadence servable exports for the online-learning loop.

    The trainer's ``--export_steps`` hook calls :meth:`export` every N
    optimizer steps; each call lands a complete versioned servable at
    ``<export_base>/<version>/`` (atomic ``publish_export``).  The
    program depends only on the model function and signature, not on the
    weight values, so it is traced on the first export and its bytes
    reused for every later version; a parameter-tree change (other
    names, shapes or dtypes) traces again.  ``traces`` counts the
    traces.

    Where the reference traces on the trainer's background writer, the
    trainer here calls :meth:`prime` on its own thread first: while
    ``torch.export`` traces it patches process-wide state
    (``builtins.max``, ``math.pow``), which must not change under a
    training step running beside it.
    """

    def __init__(self, export_base, model_name="", quantize=None, keep=16,
                 wire_format="npz"):
        """``keep``: source-base retention; after each export only the
        newest ``keep`` versions remain (0 = keep everything).  Keep it
        above the aggregator's window.

        ``wire_format``: ``"npz"`` (a zip archive any loader reads) or
        ``"frame"`` (``model.frame``, the binary wire format, decoded by
        the aggregation tier as views over one file read).  Frame
        exports get a ``frame+`` format prefix, so a serving loader
        refuses them: the source base feeds the aggregator, which
        publishes plain npz servables for the fleet."""
        if wire_format not in ("npz", "frame"):
            raise ValueError("wire_format must be 'npz' or 'frame', "
                             "got %r" % (wire_format,))
        self.export_base = export_base
        self.model_name = model_name
        self.quantize = quantize
        self.keep = int(keep)
        self.wire_format = wire_format
        self._program = None        # cached program bytes
        self._tree_key = None       # {name: (shape, dtype)} cache key
        self._poly = None
        self._signature = None
        self._out_signature = None
        self._zoo = None
        self._program_unsent = False  # no frame has carried it yet
        self.exports = 0
        self.traces = 0
        # stream_to outcomes (the cross-host push hook's telemetry)
        self.stream_stats = {"pushed": 0, "stale": 0, "reprimed": 0}

    def _key(self, flat):
        return {n: (tuple(np.shape(v)), str(np.asarray(v).dtype))
                for n, v in flat.items()}

    def prime(self, serve, params, example_input):
        """Trace the program now, on the caller's thread, unless one is
        cached for this parameter tree; returns whether it traced."""
        key = self._key(params)
        if self._program is not None and key == self._tree_key:
            return False
        start = time.perf_counter()
        (self._program, self._poly, self._signature,
         self._out_signature) = trace_servable(serve, dict(params),
                                               example_input)
        self._tree_key = key
        self._zoo = serve.zoo
        self._program_unsent = True
        self.traces += 1
        logger.info("continuous export: program traced in %.2f s (%d "
                    "bytes)", time.perf_counter() - start,
                    len(self._program))
        return True

    def _prepare(self, serve, params, example_input, embeddings):
        """The shared half of :meth:`export` and :meth:`frame_bytes`:
        trace (or reuse) the program, encode the payload, assemble the
        manifest from what was encoded.  Returns (payload, manifest)."""
        flat = dict(params)
        self.prime(serve, flat, example_input)
        payload, quantized, table_names, emb_quantized = _encode(
            flat, embeddings, self.quantize)
        manifest = _manifest_for(
            self.model_name, 0, flat, table_names, quantized,
            emb_quantized, self._poly, self._signature,
            self._out_signature, zoo=self._zoo)
        return payload, manifest

    def export(self, version, serve, params, example_input,
               embeddings=None):
        """Write ``<export_base>/<version>/``; returns the manifest."""
        version = int(version)
        export_dir = os.path.join(self.export_base, str(version))
        if os.path.isfile(os.path.join(export_dir, "manifest.json")):
            # A complete version is immutable: a restarted worker
            # re-exporting the version it already wrote must not
            # swap-rewrite it (the swap is not single-rename atomic).
            logger.info("continuous export: version %d already "
                        "complete, skipped", version)
            with open(os.path.join(export_dir, "manifest.json")) as f:
                return json.load(f)
        payload, manifest = self._prepare(serve, params, example_input,
                                          embeddings)
        manifest["version"] = version
        if self.wire_format == "frame":
            manifest["format"] = "frame+" + manifest["format"]
            weights = {"model.frame":
                       servable_frame_bytes(payload, manifest)}
        else:
            weights = {"model.npz": _npz_bytes(payload)}
        publish_export(export_dir, {
            **weights,
            PROGRAM_FILE: self._program,
            "manifest.json": json.dumps(manifest, indent=2).encode(),
        })
        logger.info("continuous export: version %d at %s (%s wire, "
                    "program of trace %d)", version, export_dir,
                    self.wire_format, self.traces)
        self.exports += 1
        self._gc()
        return manifest

    def frame_bytes(self, version, serve, params, example_input,
                    embeddings=None, include_program=None):
        """One servable version as a streaming frame, with no
        filesystem: the bytes an aggregator's ``ingest_frame`` takes.
        The program rides inside exactly when the parameter tree is new
        to the stream (the first frame after a trace: first call, tree
        change); ``include_program=True`` forces it along (re-priming a
        receiver that restarted and lost its cache)."""
        version = int(version)
        payload, manifest = self._prepare(serve, params, example_input,
                                          embeddings)
        manifest["version"] = version
        manifest["format"] = "frame+" + manifest["format"]
        if include_program is None:
            include_program = self._program_unsent
        if include_program:
            self._program_unsent = False
        blob = servable_frame_bytes(
            payload, manifest,
            program=self._program if include_program else None)
        self.exports += 1
        return blob

    def stream_to(self, client, version, serve, params, example_input,
                  embeddings=None):
        """Push one version to an aggregator's streamed-ingest endpoint
        (``POST /ingest``, ``aggregation/main.py``) through a
        ``client/frame_client.FrameClient``: trainer and aggregator
        share no filesystem.

        Returns the ingested version, or None when the aggregator
        already had this version or newer (its version-monotone 409;
        counted).  A 422 (the aggregator restarted and lost its program
        cache) re-primes: the same version is re-sent with the program
        in-band.  Malformed-frame 400s and transport failures
        propagate."""
        from elasticdl_tpu_torch.client.frame_client import (
            ProgramRequiredError,
            StaleVersionError,
        )

        blob = self.frame_bytes(version, serve, params, example_input,
                                embeddings=embeddings)
        try:
            try:
                ingested = client.ingest(blob)
            except ProgramRequiredError:
                logger.info(
                    "aggregator lost its program cache; re-priming "
                    "version %d with the program in-band", version)
                self.stream_stats["reprimed"] += 1
                ingested = client.ingest(self.frame_bytes(
                    version, serve, params, example_input,
                    embeddings=embeddings, include_program=True))
        except StaleVersionError:
            self.stream_stats["stale"] += 1
            return None
        self.stream_stats["pushed"] += 1
        return ingested

    def _gc(self):
        """Source-base retention: keep only the newest ``keep`` versions
        (and reap staging leftovers: this exporter owns the base)."""
        if not self.keep:
            return
        from elasticdl_tpu_torch.serving.loader import list_versions

        versions = list_versions(self.export_base, gc_incomplete=True)
        for version in versions[:-self.keep]:
            shutil.rmtree(
                os.path.join(self.export_base, str(version)),
                ignore_errors=True)
