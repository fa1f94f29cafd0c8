"""xDeepFM: CIN + DNN + linear (counterpart of
``elasticdl_tpu/models/xdeepfm.py``; dac_ctr zoo parity).

The Compressed Interaction Network runs over the PS-served factor table;
the feature convention of ``models/deepfm.py``.  The parameters keep the
JAX names (``cin_w%d`` ``[H_prev, F, H]``, ``deep_w%d``, ``deep_b%d``,
``out_w``, ``out_b``); a 2-D kernel is held ``[out, in]`` and
``params_from_jax`` / ``params_to_jax`` map it, the 3-D CIN weights keep
the JAX layout.

The CIN layer is the JAX ``einsum("bik,bjk,ijh->bhk", x, x0, w)``
written as two contractions in an order chosen here, not left to
``torch.einsum``: first the outer product ``z[b, i, j, k] = x[b, i, k] *
x0[b, j, k]`` (no sum), then one matmul over the ``i, j`` pairs,
``w.reshape(I * J, H)ᵀ @ z.reshape(B, I * J, k)``.  Each output is a
float32 sum of ``I * J`` products (80 to 160 at the zoo's widths) where
XLA may sum over ``j`` first; the two agree to a few float32 ulps of the
largest term, within the zoo twins' 2e-5 + 1e-5 relative.
"""

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mlp import DenseParams
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.utils.device import resolve_device

EMB_TABLE = "xdeepfm_embedding"
LIN_TABLE = "xdeepfm_linear"


def init_params(generator, num_dense, num_fields, embedding_dim,
                cin_sizes=(16, 16), hidden=(128, 64)):
    """The JAX ``init_params``' families from ``generator``: CIN weights
    normal / sqrt(H_prev * F), He-normal deep kernels, an output kernel
    of std 0.01, zero biases; float32, in the module's layouts."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    params = {}
    prev = num_fields
    for i, h in enumerate(cin_sizes):
        params["cin_w%d" % i] = normal(prev, num_fields, h) / np.sqrt(
            prev * num_fields)
        prev = h
    sizes = [num_fields * embedding_dim + num_dense] + list(hidden)
    for i in range(len(hidden)):
        params["deep_w%d" % i] = normal(sizes[i + 1], sizes[i]) * np.sqrt(
            2.0 / sizes[i])
        params["deep_b%d" % i] = torch.zeros(sizes[i + 1], device=dev)
    params["out_w"] = normal(1, sum(cin_sizes) + sizes[-1]) * 0.01
    params["out_b"] = torch.zeros(1, device=dev)
    return params


def cin_layer(x, x0, w):
    """``out[b, h, k] = sum_ij w[i, j, h] x[b, i, k] x0[b, j, k]`` as the
    module docstring's two contractions: x [B, I, k], x0 [B, J, k], w
    [I, J, H] -> [B, H, k]."""
    b, i, k = x.shape
    j = x0.shape[1]
    z = (x[:, :, None, :] * x0[:, None, :, :]).reshape(b, i * j, k)
    return torch.matmul(w.reshape(i * j, -1).t(), z)


def forward(params, feats):
    x0 = feats["emb__" + EMB_TABLE][feats["idx__" + EMB_TABLE]]  # [B,F,k]
    first = feats["emb__" + LIN_TABLE][feats["idx__" + LIN_TABLE]][
        ..., 0].sum(dim=1)                                       # [B]
    # CIN: X^l[b,h,k] = sum_ij W[l][i,j,h] X^{l-1}[b,i,k] X^0[b,j,k]
    pooled = []
    x = x0
    n_cin = sum(1 for k in params if k.startswith("cin_w"))
    for i in range(n_cin):
        x = cin_layer(x, x0, params["cin_w%d" % i])
        pooled.append(x.sum(dim=-1))                             # [B,H]
    cin_out = torch.cat(pooled, dim=-1)
    # DNN
    h = x0.reshape(x0.shape[0], -1)
    if feats.get("dense") is not None:
        h = torch.cat([h, feats["dense"]], dim=-1)
    n_deep = sum(1 for k in params if k.startswith("deep_w"))
    for i in range(n_deep):
        h = torch.relu(F.linear(h, params["deep_w%d" % i],
                                params["deep_b%d" % i]))
    out = F.linear(torch.cat([cin_out, h], dim=-1), params["out_w"])
    return first + out[:, 0] + params["out_b"][0]


def feed(records):
    dense = np.stack([np.asarray(r[0], np.float32) for r in records])
    ids = np.stack([np.asarray(r[1], np.int64) for r in records])
    labels = np.asarray([int(r[2]) for r in records], np.int32)
    return {"dense": dense, "__ids__": {EMB_TABLE: ids, LIN_TABLE: ids}}, \
        labels


def model_spec(num_dense=4, num_fields=8, vocab_size=10000,
               embedding_dim=8, cin_sizes=(16, 16), hidden=(128, 64),
               learning_rate=1e-3):
    del vocab_size  # the PS tables grow lazily; no size is fixed

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, num_dense, num_fields, embedding_dim,
                             cin_sizes, hidden)
        return DenseParams(params, forward).to(device)

    return ModelSpec(
        name="xdeepfm", init_fn=init_fn,
        apply_fn=lambda module, feats, train: module(feats),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, loss_fn=_ctr.loss_fn,
        optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=_ctr.eval_metrics,
        ps_embedding_infos=[
            {"name": EMB_TABLE, "dim": embedding_dim,
             "initializer": "uniform"},
            {"name": LIN_TABLE, "dim": 1, "initializer": "zeros"},
        ],
        ps_optimizer=("adam", "learning_rate=%g" % learning_rate),
    )


synthetic_data = _ctr.synthetic_data
