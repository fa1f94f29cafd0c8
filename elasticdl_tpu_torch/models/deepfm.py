"""DeepFM with parameter-server embeddings, the sparse CTR path
(counterpart of ``elasticdl_tpu/models/deepfm.py``).

Two PS tables: second-order factor embeddings ``deepfm_embedding``
``[V, k]`` and first-order linear weights ``deepfm_linear`` ``[V, 1]``.
The dense part, an MLP over the flattened factors and the dense
features plus a global ``bias``, lives on the PS too; the
``ParameterServerTrainer`` pulls and pushes it.

Features arrive as ``{"dense": [B, Dn] float, "__ids__": {table: [B, F]}}``
(categorical ids pre-offset into one vocab space), and the trainer adds
``emb__<table>`` (the pulled rows ``[U, dim]``, leaf tensors whose
gradients it pushes) and ``idx__<table>`` (``[B, F]`` indices into them).

The parameters keep the JAX names (``w%d``, ``b%d``, ``bias``); a kernel
``w%d`` is held ``[out, in]`` here (``models/mlp.py``), so the PS, which
holds the JAX layouts, and its checkpoints are the JAX package's.
``params_from_jax`` / ``params_to_jax`` map the two.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.models.mlp import mlp_apply, mlp_init
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device

EMB_TABLE = "deepfm_embedding"
LIN_TABLE = "deepfm_linear"


class DeepFM(nn.Module):
    """The dense part: ``w%d``/``b%d`` of the MLP and the global bias,
    registered under the JAX names."""

    def __init__(self, params):
        super().__init__()
        for name, value in sorted(params.items()):
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, feats):
        emb_rows = feats["emb__" + EMB_TABLE]        # [U, k]
        emb_idx = feats["idx__" + EMB_TABLE]         # [B, F]
        lin_rows = feats["emb__" + LIN_TABLE]        # [U, 1]
        lin_idx = feats["idx__" + LIN_TABLE]         # [B, F]
        dense = feats.get("dense")

        v = emb_rows[emb_idx]                        # [B, F, k]
        first = lin_rows[lin_idx][..., 0].sum(dim=1)             # [B]
        # FM second order: 0.5 * ((sum v)^2 - sum v^2)
        sum_v = v.sum(dim=1)                                     # [B, k]
        second = 0.5 * (sum_v.square()
                        - v.square().sum(dim=1)).sum(dim=-1)     # [B]
        flat = v.reshape(v.shape[0], -1)
        x = torch.cat([flat, dense], dim=-1) if dense is not None else flat
        deep = mlp_apply(dict(self.named_parameters()), x)[:, 0]  # [B]
        return first + second + deep + self.bias[0]


def init_params(generator, num_dense, num_fields, embedding_dim,
                hidden=(128, 64)):
    """He-initialized MLP weights (``models/mlp.py``) and a zero bias,
    drawn from ``generator``, in the module's layouts."""
    sizes = [num_fields * embedding_dim + num_dense] + list(hidden) + [1]
    params = mlp_init(sizes, generator)
    params["bias"] = torch.zeros(1, device=generator.device)
    return params


def loss_fn(logits, labels):
    """Per-example sigmoid cross entropy (``optax.sigmoid_binary_cross_
    entropy``)."""
    return F.binary_cross_entropy_with_logits(
        logits.float(), labels.float(), reduction="none")


def feed(records):
    dense = np.stack([np.asarray(r[0], np.float32) for r in records])
    ids = np.stack([np.asarray(r[1], np.int64) for r in records])
    labels = np.asarray([int(r[2]) for r in records], np.int32)
    return {"dense": dense, "__ids__": {EMB_TABLE: ids, LIN_TABLE: ids}}, \
        labels


def model_spec(num_dense=4, num_fields=8, vocab_size=10000,
               embedding_dim=8, learning_rate=1e-3, hidden=(128, 64)):
    del vocab_size  # the PS tables grow lazily; no size is fixed

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, num_dense, num_fields, embedding_dim,
                             hidden)
        return DeepFM(params).to(device)

    return ModelSpec(
        name="deepfm", init_fn=init_fn,
        apply_fn=lambda module, feats, train: module(feats),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, loss_fn=loss_fn,
        eval_metrics_fn=lambda: {
            "auc": metrics.AUC(),
            "accuracy": metrics.BinaryAccuracy(threshold=0.0),
        },
        ps_embedding_infos=[
            {"name": EMB_TABLE, "dim": embedding_dim,
             "initializer": "uniform"},
            {"name": LIN_TABLE, "dim": 1, "initializer": "zeros"},
        ],
        ps_optimizer=("adam", "learning_rate=%g" % learning_rate),
    )


def synthetic_data(n=1024, num_dense=4, num_fields=8, vocab_size=10000,
                   seed=0):
    """Learnable synthetic CTR data: the label depends on a hidden weight
    per category id, so embeddings must be learned for AUC > 0.5."""
    rng = np.random.RandomState(seed)
    hidden_w = rng.randn(vocab_size) * 0.5
    dense = rng.rand(n, num_dense).astype(np.float32)
    field_offsets = (
        np.arange(num_fields) * (vocab_size // num_fields)
    )
    raw = rng.randint(0, vocab_size // num_fields, size=(n, num_fields))
    ids = (raw + field_offsets[None, :]).astype(np.int64)
    score = hidden_w[ids].sum(axis=1) + dense.sum(axis=1) - num_dense / 2
    labels = (score > 0).astype(np.int32)
    return dense, ids, labels
