"""Loader for servable exports (counterpart of
``elasticdl_tpu/serving/loader.py``).

Reads the port's ``elasticdl_tpu_torch_servable_v1`` exports, whose
manifest names the zoo entry that rebuilds the module, and the
``model.npz`` of the JAX package's ``elasticdl_tpu_servable_v2`` exports
when the caller names the zoo entry (``zoo=("resnet",
"variant=resnet50")``): both store weights in the JAX package's flat
names and layouts.

Numerics: a float32 conv on the card runs through cuDNN in TF32 by
default, and the JAX servable computes in float32.  Loading a servable
onto a CUDA device therefore turns TF32 off for convs and matmuls in
the process, so that served predictions keep float32 accuracy.
"""

import json
import os

import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.serving.export import FORMAT
from elasticdl_tpu_torch.utils.device import (resolve_device,
                                              use_float32_numerics)

JAX_FORMAT = "elasticdl_tpu_servable_v2"


def list_versions(path):
    """Complete numeric versions under a TF-Serving-style base
    (``path/<N>/`` with a manifest.json; the exporter publishes a version
    dir atomically, so the manifest marks a finished export), sorted
    ascending.  Empty when ``path`` is a direct export dir.  Staging
    leftovers and manifest-less dirs are skipped."""
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return []
    try:
        entries = os.listdir(path)
    except OSError:
        entries = []
    return sorted(
        int(entry) for entry in entries
        if entry.isdigit() and os.path.isfile(
            os.path.join(path, entry, "manifest.json")))


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


class ServableModel:
    """One loaded export on one device.  ``zoo``: ``(module,
    model_params)`` naming the zoo entry; required for a JAX-written
    export, and overrides the manifest's for a port export."""

    def __init__(self, export_dir, device=None, zoo=None):
        export_dir = resolve_export_dir(export_dir)
        self.export_dir = export_dir
        self.device = resolve_device(device)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        fmt = self.manifest.get("format", "")
        if fmt == FORMAT:
            zoo = zoo or (self.manifest["zoo"]["module"],
                          self.manifest["zoo"]["model_params"])
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
        with np.load(os.path.join(export_dir, "model.npz")) as z:
            named = {key: z[key] for key in z.files}
        if self.device.type == "cuda":
            use_float32_numerics()
        self.module = spec.init_fn(self.device)
        self.module.load_state_dict(spec.params_from_jax(named))
        self._apply = spec.apply_fn

    def predict(self, inputs):
        """ndarray matching ``manifest['input_signature']`` -> ndarray."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(inputs), device=self.device)
            return self._apply(self.module, x, False).cpu().numpy()

    def dummy_inputs(self, batch_size):
        """Zero-filled inputs matching the signature, with every free
        (None) dim set to ``batch_size``."""
        sig = self.manifest["input_signature"]
        shape = [batch_size if d is None else d for d in sig["shape"]]
        return np.zeros(shape, np.dtype(sig["dtype"]))


def load_servable(export_dir, device=None, zoo=None):
    return ServableModel(export_dir, device=device, zoo=zoo)
