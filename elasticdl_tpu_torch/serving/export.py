"""Servable export (counterpart of ``elasticdl_tpu/serving/export.py``).

Export layout (format ``elasticdl_tpu_torch_servable_v1``)::

    export_dir/
      manifest.json   format tag, model name/version, input signature,
                      parameter names, and the zoo entry that rebuilds
                      the module: {"module": ..., "model_params": ...}
      model.npz       {slash/joined/name: ndarray} in the JAX package's
                      flat names and layouts (``params_to_jax``)

There is no traced program: the loader rebuilds the module from the
port's own zoo and loads the weights into it.  Because the weights use
the JAX package's names and layouts, the same ``model.npz`` loads into
either package.
"""

import io
import json
import os
import shutil

import numpy as np

from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

FORMAT = "elasticdl_tpu_torch_servable_v1"


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


def _leaf_signature(example):
    """One input leaf's ``{shape, dtype}``, its leading (batch) dim
    free; a rank-0 leaf (a per-request scalar) keeps its empty shape."""
    example = np.asarray(example)
    shape = list(example.shape)
    if shape:
        shape[0] = None
    return {"shape": shape, "dtype": str(example.dtype)}


def export_servable(export_dir, spec_name, model_params, module,
                    example_input, model_name="", version=0,
                    generate=None):
    """Write a servable export of ``module``.

    ``spec_name`` / ``model_params``: the zoo entry that rebuilds the
    module (``load_model_spec(spec_name, model_params)``), recorded in
    the manifest.  ``example_input``: an ndarray, or a flat dict of
    them, fixing the serving signature (the JAX package's layout:
    ``{shape, dtype}`` per leaf, leading dim free).  ``generate``: the
    settings of a generation export (``prompt_len``,
    ``max_new_tokens``, ``temperature``), recorded as the manifest's
    ``"generate"`` block; the loader then serves the zoo entry's
    ``generate_fn``.  Returns the manifest."""
    spec = load_model_spec(spec_name, model_params)
    flat = spec.params_to_jax(module)
    if isinstance(example_input, dict):
        signature = {key: _leaf_signature(value)
                     for key, value in example_input.items()}
    else:
        signature = _leaf_signature(example_input)
    manifest = {
        "format": FORMAT,
        "model_name": model_name,
        "version": version,
        "parameters": sorted(flat),
        "input_signature": signature,
        "zoo": {"module": spec_name, "model_params": model_params},
        "loader": "elasticdl_tpu_torch.serving.loader:load_servable",
    }
    if generate is not None:
        manifest["generate"] = dict(generate)
    publish_export(export_dir, {
        "model.npz": _npz_bytes(flat),
        "manifest.json": json.dumps(manifest, indent=2).encode(),
    })
    logger.info("servable export at %s (%d tensors)", export_dir, len(flat))
    return manifest


def load_export(export_dir):
    """An export's weights as ({name: ndarray}, {table: (ids, values)})
    (counterpart of ``models/callbacks.load_export``): the ``model.npz``
    that this package's exporter writes, or the JAX package's, in the JAX
    package's flat names; embedding tables as its ``emb_ids/<table>`` and
    ``emb_vals/<table>`` pairs.  int8-quantized exports raise."""
    with np.load(os.path.join(export_dir, "model.npz")) as z:
        payload = {key: z[key] for key in z.files}
    if any(key.startswith(("q8/", "q8emb/")) for key in payload):
        raise NotImplementedError(
            "int8-quantized exports are not ported yet (ROADMAP A11)")
    dense, embeddings = {}, {}
    for key, value in payload.items():
        if key.startswith("emb_ids/"):
            name = key[len("emb_ids/"):]
            embeddings[name] = (value, payload["emb_vals/" + name])
        elif not key.startswith("emb_vals/"):
            dense[key] = value
    return dense, embeddings
