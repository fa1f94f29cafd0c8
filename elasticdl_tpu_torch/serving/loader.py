"""Loader for servable exports (counterpart of
``elasticdl_tpu/serving/loader.py``).

Reads the port's ``elasticdl_tpu_torch_servable_v1`` exports, whose
manifest names the zoo entry that rebuilds the module, and the
``model.npz`` of the JAX package's ``elasticdl_tpu_servable_v2`` exports
when the caller names the zoo entry (``zoo=("resnet",
"variant=resnet50")``): both store weights in the JAX package's flat
names and layouts.  A generation export (a manifest with a
``"generate"`` block, written by ``models/transformer.export_generate``;
for a JAX ``export_generate`` export the caller passes ``generate=``)
runs the zoo entry's ``generate_fn`` on each ``predict``.

Inputs and outputs are one array or a tree (dicts, lists, tuples) of
them, as the JAX servable takes and returns.  An export's embedding
tables (``emb_ids/<t>``, ``emb_vals/<t>``, either package's) load into
``ServableModel.embeddings`` and answer ``lookup_embedding``, the
``:lookup`` surface.  int8-quantized exports are refused (ROADMAP A11).

Numerics: a float32 conv on the card runs through cuDNN in TF32 by
default, and the JAX servable computes in float32.  Loading a servable
changes no process-wide setting (as the JAX loader); the serving entry
point (``serving/server.py:main``) turns TF32 off before it loads one.
"""

import json
import os
import shutil

import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.serving.export import FORMAT, load_export
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


class ServableModel:
    """One loaded export on one device.  ``zoo``: ``(module,
    model_params)`` naming the zoo entry; required for a JAX-written
    export, and overrides the manifest's for a port export.
    ``generate``: ``{prompt_len, max_new_tokens, temperature}`` of a
    JAX-written ``export_generate`` export (its manifest does not carry
    them); a port export's manifest does."""

    def __init__(self, export_dir, device=None, zoo=None, generate=None):
        export_dir = resolve_export_dir(export_dir)
        self.export_dir = export_dir
        self.device = resolve_device(device)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        fmt = self.manifest.get("format", "")
        if fmt == FORMAT:
            zoo = zoo or (self.manifest["zoo"]["module"],
                          self.manifest["zoo"]["model_params"])
            generate = generate or self.manifest.get("generate")
        elif fmt == JAX_FORMAT:
            # Plain-weights JAX exports only: a feature prefix
            # ("int8-weights+...") is refused by the equality above.
            if zoo is None:
                raise ValueError(
                    "a JAX-written export carries no zoo entry; pass "
                    "zoo=(module, model_params)")
        else:
            raise ValueError(
                "not a servable export this loader understands: "
                "format=%r" % fmt)
        spec = load_model_spec(*zoo)
        if generate is not None and spec.generate_fn is None:
            raise ValueError("zoo entry %r serves no generation" % (zoo[0],))
        named, self.embeddings = load_export(export_dir)
        # Sorted-id index per table, built once: a lookup is then
        # O(batch log table) through searchsorted.
        self._emb_index = {}
        for name, (ids, _values) in self.embeddings.items():
            ids = np.asarray(ids)
            order = np.argsort(ids, kind="stable")
            srt = ids[order]
            if len(srt) > 1:
                # A repeated id keeps its last row (last write wins).
                keep = np.ones(len(srt), bool)
                keep[:-1] = srt[1:] != srt[:-1]
                srt, order = srt[keep], order[keep]
            self._emb_index[name] = (srt, order)
        self.module = spec.init_fn(self.device)
        self.module.load_state_dict(spec.params_from_jax(named))
        self._apply = spec.apply_fn
        self._generate_fn = spec.generate_fn
        self.generate = dict(generate) if generate is not None else None

    def predict(self, inputs):
        """Inputs matching ``manifest['input_signature']`` (an array, or
        a tree of them) -> the module's outputs as ndarrays, in the same
        tree.  A generation export takes prompt ids [B, prompt_len] (or,
        when it samples, ``{"prompt": ..., "seed": s}``) and answers
        prompt + generated ids [B, prompt_len + max_new_tokens] int32."""
        with torch.inference_mode():
            if self.generate is not None:
                return self._predict_generate(inputs)
            x = tree_map(lambda a: torch.as_tensor(_writable(a),
                                                   device=self.device),
                         inputs)
            return tree_map(lambda t: t.cpu().numpy(),
                            self._apply(self.module, x, False))

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
