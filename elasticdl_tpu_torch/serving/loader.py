"""Loader for servable exports (counterpart of
``elasticdl_tpu/serving/loader.py``).

Three routes, chosen by the manifest:

 - the program route: a port export whose manifest names a program
   (``"program": "model.pt2"``, ``serving/export.py``) runs that
   ``torch.export`` program on the weights of ``model.npz``.  It needs
   no model zoo: this module imports ``serving/export.py`` (the payload
   codec), ``utils`` and ``ops`` (which register the kernels' custom
   ops), never ``models``, ``worker`` or ``master``.  A program written
   on one device runs on the other (``move_to_device_pass``).  A program
   that fails to load raises; the loader never rebuilds the module from
   the zoo in its place;
 - the zoo route: a port export without a program (written before the
   program existed, or a generation export) rebuilds the module from the
   manifest's zoo entry; a JAX package's ``elasticdl_tpu_servable_v2``
   export loads its ``model.npz`` the same way when the caller names the
   zoo entry (``zoo=("resnet", "variant=resnet50")``).  Both store
   weights in the JAX package's flat names and layouts.  A generation
   export (a manifest with a ``"generate"`` block; for a JAX
   ``export_generate`` export the caller passes ``generate=``) runs the
   zoo entry's ``generate_fn`` on each ``predict``.

Feature prefixes on the format tag gate what this copy understands, as
in the reference: ``int8-weights+`` and ``int8-emb+`` are dequantized at
load; any other prefix (``frame+``, the aggregation tier's source
carrier, among them) is refused at load.

Inputs and outputs are one array or a tree (dicts, lists, tuples) of
them, as the JAX servable takes and returns.  An export's embedding
tables (``emb_ids/<t>``, ``emb_vals/<t>``, either package's) load into
``ServableModel.embeddings`` and answer ``lookup_embedding``, the
``:lookup`` surface.

Numerics: a float32 conv on the card runs through cuDNN in TF32 by
default, and the JAX servable computes in float32.  Loading a servable
changes no process-wide setting (as the JAX loader); the serving entry
point (``serving/server.py:main``) turns TF32 off before it loads one.
"""

import io
import json
import os
import shutil

import numpy as np
import torch

from elasticdl_tpu_torch.ops import flash_attention as _fa  # noqa: F401
from elasticdl_tpu_torch.ops import group_norm as _gn  # noqa: F401
from elasticdl_tpu_torch.serving.export import (
    FORMAT,
    FORWARD_PROGRAM,
    LAYOUT_PROGRAM,
    PROGRAM_LOCK,
    load_payload,
    program_archives,
)
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.pytree import tree_map

JAX_FORMAT = "elasticdl_tpu_servable_v2"


def list_versions(path, gc_incomplete=False):
    """Complete numeric versions under a TF-Serving-style base
    (``path/<N>/`` with a manifest.json; the exporter publishes a version
    dir atomically, so the manifest marks a finished export), sorted
    ascending.  Empty when ``path`` is a direct export dir.

    Incomplete dirs are always skipped; with ``gc_incomplete`` they are
    also removed: ``*.tmp-*`` staging leftovers of a crashed writer and
    numeric dirs without a manifest.  ``*.old-*`` dirs are never reaped
    (after a crash mid-swap one can be the only complete copy).  Only
    the owner of the export base passes ``gc_incomplete``: a reader must
    not reap another writer's staging dir."""
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return []
    try:
        entries = os.listdir(path)
    except OSError:
        entries = []
    complete = []
    for entry in entries:
        sub = os.path.join(path, entry)
        if entry.isdigit():
            if os.path.isfile(os.path.join(sub, "manifest.json")):
                complete.append(int(entry))
            elif gc_incomplete and os.path.isdir(sub):
                shutil.rmtree(sub, ignore_errors=True)
        elif gc_incomplete and ".tmp-" in entry and os.path.isdir(sub):
            shutil.rmtree(sub, ignore_errors=True)
    return sorted(complete)


def resolve_export_dir(path, version=None):
    """A direct export dir, or the dir of the highest complete version
    (or of ``version``) under a versioned base."""
    if version is None and os.path.isfile(
            os.path.join(path, "manifest.json")):
        return path
    if version is not None:
        sub = os.path.join(path, str(int(version)))
        if os.path.isfile(os.path.join(sub, "manifest.json")):
            return sub
        raise FileNotFoundError(
            "no complete version %s under %r" % (version, path))
    versions = list_versions(path)
    if not versions:
        raise FileNotFoundError(
            "no manifest.json in %r and no complete numeric version "
            "subdirectory under it" % path)
    return os.path.join(path, str(versions[-1]))


def _writable(a):
    """``a`` as an ndarray torch may wrap: a read-only view (a binary
    frame's payload) is copied."""
    a = np.asarray(a)
    return a if a.flags.writeable else a.copy()


def is_leaf_signature(signature):
    """True for one array's ``{shape, dtype}``, False for a dict of
    them (a dict-input servable such as a sampling generate export)."""
    return isinstance(signature.get("shape"), list)


KNOWN_PREFIXES = ("int8-weights", "int8-emb")


def _check_format(fmt):
    """(base format, prefixes); refuses an unknown feature prefix."""
    *prefixes, base = fmt.split("+")
    if base not in (FORMAT, JAX_FORMAT) or set(prefixes) - set(
            KNOWN_PREFIXES):
        raise ValueError(
            "not a servable export this loader understands: format=%r "
            "(known feature prefixes: %s)" % (fmt, sorted(KNOWN_PREFIXES)))
    return base


def load_program(path, device):
    """The programs of the file at ``path``, moved to ``device``, as two
    callable modules: (layout, forward)."""
    from torch.export.passes import move_to_device_pass

    with open(path, "rb") as f:
        archives = program_archives(f.read())
    with PROGRAM_LOCK:
        return tuple(
            move_to_device_pass(torch.export.load(io.BytesIO(
                archives[name])), str(device)).module()
            for name in (LAYOUT_PROGRAM, FORWARD_PROGRAM))


def _ordered(tree, signature):
    """``tree`` with every dict's keys in the signature's order (the
    order the program was traced with), each leaf's shape held to the
    signature (a None dim takes any size).  The loader checks here what
    the program's own input check would: that check also walks every
    state tensor, on every call."""
    if isinstance(signature, dict) and is_leaf_signature(signature):
        want = signature["shape"]
        shape = tuple(tree.shape)
        if len(shape) != len(want) or any(
                w is not None and w != d for w, d in zip(want, shape)):
            raise ValueError("input of shape %s, the servable takes %s"
                             % (list(shape), want))
        return tree
    if isinstance(signature, dict):
        if not isinstance(tree, dict) or set(tree) != set(signature):
            raise ValueError("inputs %s, the servable takes %s" % (
                sorted(tree) if isinstance(tree, dict) else type(tree),
                sorted(signature)))
        return {key: _ordered(tree[key], signature[key])
                for key in signature}
    if len(tree) != len(signature):
        raise ValueError("%d inputs, the servable takes %d"
                         % (len(tree), len(signature)))
    return type(tree)(_ordered(t, sig) for t, sig in zip(tree, signature))


def _weights(export_dir):
    """(dense, embeddings, sorted-id index per table) of an export.  The
    index is built once: a lookup is then O(batch log table) through
    searchsorted."""
    named, embeddings = load_payload(export_dir)
    index = {}
    for name, (ids, _values) in embeddings.items():
        ids = np.asarray(ids)
        order = np.argsort(ids, kind="stable")
        srt = ids[order]
        if len(srt) > 1:
            # A repeated id keeps its last row (last write wins).
            keep = np.ones(len(srt), bool)
            keep[:-1] = srt[1:] != srt[:-1]
            srt, order = srt[keep], order[keep]
        index[name] = (srt, order)
    return named, embeddings, index


class ServableModel:
    """One loaded export on one device.  ``zoo``: ``(module,
    model_params)`` naming the zoo entry; required for a JAX-written
    export, and for a port export it takes the zoo route with that
    entry.  ``generate``: ``{prompt_len, max_new_tokens, temperature}``
    of a JAX-written ``export_generate`` export (its manifest does not
    carry them); a port export's manifest does."""

    def __init__(self, export_dir, device=None, zoo=None, generate=None):
        export_dir = resolve_export_dir(export_dir)
        self.export_dir = export_dir
        self.device = resolve_device(device)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        base = _check_format(self.manifest.get("format", ""))
        named, self.embeddings, self._emb_index = _weights(export_dir)
        self.program = self.module = None
        if base == FORMAT:
            program = self.manifest.get("program")
            if zoo is None and program and not generate:
                layout, self.program = load_program(
                    os.path.join(export_dir, program), self.device)
                # The weights in the module's layouts, on the device,
                # once per loaded version: the layout program takes them
                # as one dict in the manifest's (sorted) order.
                with torch.inference_mode():
                    self._state = layout({
                        name: torch.as_tensor(_writable(named[name])).to(
                            self.device)
                        for name in self.manifest["parameters"]})
                self.generate = None
                return
            zoo = zoo or (self.manifest["zoo"]["module"],
                          self.manifest["zoo"]["model_params"])
            generate = generate or self.manifest.get("generate")
        elif zoo is None:
            raise ValueError(
                "a JAX-written export carries no zoo entry; pass "
                "zoo=(module, model_params)")
        from elasticdl_tpu_torch.models.spec import load_model_spec

        spec = load_model_spec(*zoo)
        if generate is not None and spec.generate_fn is None:
            raise ValueError("zoo entry %r serves no generation" % (zoo[0],))
        self.module = spec.init_fn(self.device)
        self.module.load_state_dict(spec.params_from_jax(named))
        self._apply = spec.apply_fn
        self._generate_fn = spec.generate_fn
        self.generate = dict(generate) if generate is not None else None

    def predict(self, inputs):
        """Inputs matching ``manifest['input_signature']`` (an array, or
        a tree of them) -> the outputs as ndarrays, in the same tree.  A
        generation export takes prompt ids [B, prompt_len] (or, when it
        samples, ``{"prompt": ..., "seed": s}``) and answers prompt +
        generated ids [B, prompt_len + max_new_tokens] int32."""
        with torch.inference_mode():
            if self.generate is not None:
                return self._predict_generate(inputs)
            x = tree_map(lambda a: torch.as_tensor(_writable(a),
                                                   device=self.device),
                         inputs)
            if self.program is not None:
                # ``forward``, past the module's call hooks: the
                # program's input check is ``_ordered``'s.
                out = self.program.forward(self._state, _ordered(
                    x, self.manifest["input_signature"]))
            else:
                out = self._apply(self.module, x, False)
            return tree_map(lambda t: t.cpu().numpy(), out)

    def _predict_generate(self, inputs):
        settings = self.generate
        seed = 0
        if isinstance(inputs, dict):
            prompt, seed = inputs["prompt"], int(np.asarray(inputs["seed"]))
        else:
            prompt = inputs
        prompt = np.asarray(prompt, dtype=np.int32)
        if prompt.ndim != 2 or prompt.shape[1] != settings["prompt_len"]:
            raise ValueError(
                "prompt of shape %s, the export takes [batch, %d]"
                % (prompt.shape, settings["prompt_len"]))
        tokens = self._generate_fn(
            self.module, torch.from_numpy(prompt).to(self.device),
            settings["max_new_tokens"], settings["temperature"], seed)
        return tokens.cpu().numpy()

    def dummy_inputs(self, batch_size):
        """Zero-filled inputs matching the signature, with every free
        (None) dim set to ``batch_size``."""

        def zeros(sig):
            shape = [batch_size if d is None else d for d in sig["shape"]]
            return np.zeros(shape, np.dtype(sig["dtype"]))

        sig = self.manifest["input_signature"]
        if is_leaf_signature(sig):
            return zeros(sig)
        return {key: zeros(sub) for key, sub in sig.items()}


    def lookup_embedding(self, table, ids, default=0.0):
        """Host-side rows of an exported embedding table for ``ids``,
        vectorized against the sorted-id index; unknown ids get
        ``default`` rows."""
        _known_ids, values = self.embeddings[table]
        sorted_ids, order = self._emb_index[table]
        ids = np.asarray(ids).ravel()
        dim = values.shape[1] if values.ndim > 1 else 1
        out = np.full((len(ids), dim), default, values.dtype)
        if len(sorted_ids):
            pos = np.searchsorted(sorted_ids, ids)
            pos = np.minimum(pos, len(sorted_ids) - 1)
            hit = sorted_ids[pos] == ids
            out[hit] = values.reshape(len(values), dim)[order[pos[hit]]]
        return out


def load_servable(export_dir, device=None, zoo=None, generate=None):
    return ServableModel(export_dir, device=device, zoo=zoo,
                         generate=generate)
