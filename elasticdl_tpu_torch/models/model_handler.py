"""Embedding placement planning, the ModelHandler analog (counterpart of
``elasticdl_tpu/models/model_handler.py``).

The reference swaps ``tf.keras.layers.Embedding`` for PS-backed layers
when a table exceeds 2 MB (model_handler.py:98-102, threshold at
EMBEDDING_SIZE_THRESHOLD_IN_BYTES) and reverses the transform for export.
Here the same decision routes each declared embedding table either to the
parameter server (bigger than the threshold) or to a device-resident
parameter (small tables train fastest as plain parameters inside the
step on the collective path).

``localize_spec`` rewrites a PS-style ModelSpec so chosen tables become
ordinary parameters: the model's forward already consumes
``emb__<table>[idx__<table>]``, so a local table is just the whole table
passed as ``emb__<table>`` with raw ids as indices — no model code
changes.  The table is the module's parameter ``local_emb__<table>``
on its device, the ``[V, d]`` table of the JAX package's
``params["local_emb__<table>"]``; the module holds it ``[d, V]``, the
layout in which the port holds every 2-D leaf (``spec.to_jax_layout``
transposes it back), so ``params_to_jax``, checkpoints and Adam's slots
carry JAX's ``[V, d]`` with no special case, and the forward reads its
transposed view ``[V, d]``.
"""

import dataclasses

import numpy as np
import torch

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# reference: 2 MB threshold (model_handler.py:98-102)
EMBEDDING_PS_THRESHOLD_BYTES = 2 * 1024 * 1024


def plan_embedding_placement(infos, vocab_sizes,
                             threshold_bytes=EMBEDDING_PS_THRESHOLD_BYTES):
    """Split table names into {"ps": [...], "device": [...]} by size."""
    plan = {"ps": [], "device": []}
    for info in infos:
        name = info["name"]
        vocab = vocab_sizes.get(name)
        if vocab is None:
            plan["ps"].append(name)  # unknown vocab: assume large
            continue
        size = vocab * info["dim"] * 4
        plan["device" if size < threshold_bytes else "ps"].append(name)
    return plan


def localize_spec(spec, vocab_sizes, tables=None, seed=0):
    """Return a new ModelSpec with the given tables (default: all below
    the PS threshold) turned into device-resident parameters.  Tables
    are drawn from a generator seeded with ``seed``, in name order:
    uniform in [-0.05, 0.05], or zeros where the table's initializer
    says so (the JAX package's families; its draws are ``jax.random``'s,
    so equal tables are carried by ``params_from_jax``)."""
    infos = {i["name"]: i for i in spec.ps_embedding_infos}
    if tables is None:
        tables = plan_embedding_placement(
            spec.ps_embedding_infos, vocab_sizes
        )["device"]
    tables = [t for t in tables if t in infos]
    if not tables:
        return spec
    logger.info("localizing embedding tables onto device: %s", tables)

    table_seed = int(seed)
    base_init = spec.init_fn
    base_apply = spec.apply_fn
    base_feed = spec.feed
    local_infos = {t: infos[t] for t in tables}

    def init_fn(device=None, seed=0):
        module = base_init(device, seed)
        device = next(module.parameters()).device
        gen = torch.Generator().manual_seed(table_seed)
        for t, info in sorted(local_infos.items()):
            shape = (info["dim"], vocab_sizes[t])       # [d, V]
            if info.get("initializer", "uniform") == "zeros":
                table = torch.zeros(shape)
            else:
                table = torch.rand(shape, generator=gen) * 0.1 - 0.05
            module.register_parameter(
                "local_emb__" + t, torch.nn.Parameter(table.to(device)))
        return module

    def apply_fn(module, feats, train):
        feats = dict(feats)
        for t in tables:
            feats["emb__" + t] = getattr(module, "local_emb__" + t).t()
        return base_apply(module, feats, train)

    def feed(records):
        features, labels = base_feed(records)
        ids_map = features.get("__ids__", {})
        for t in tables:
            ids = ids_map.pop(t, None)
            if ids is not None:
                features["idx__" + t] = np.asarray(ids, np.int32)
        if not ids_map:
            features.pop("__ids__", None)
        return features, labels

    return dataclasses.replace(
        spec,
        init_fn=init_fn,
        apply_fn=apply_fn,
        feed=feed,
        ps_embedding_infos=[
            i for i in spec.ps_embedding_infos
            if i["name"] not in tables
        ],
    )
