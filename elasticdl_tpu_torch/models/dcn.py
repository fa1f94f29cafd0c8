"""Deep & Cross Network (counterpart of ``elasticdl_tpu/models/dcn.py``;
dac_ctr zoo parity: the reference's model_zoo/dac_ctr has DCN beside
DeepFM, xDeepFM and wide & deep).

The PS feature convention of ``models/deepfm.py``: one factor table
served by the parameter server; the cross and deep towers run on the
device inside the step.  The parameters keep the JAX names
(``cross_w%d``, ``cross_b%d``, ``deep_w%d``, ``deep_b%d``, ``out_w``,
``out_b``); a 2-D kernel is held ``[out, in]`` and ``params_from_jax`` /
``params_to_jax`` map it, the 1-D cross weights keep their layout.
"""

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mlp import DenseParams
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.utils.device import resolve_device

EMB_TABLE = "dcn_embedding"


def init_params(generator, num_dense, num_fields, embedding_dim,
                num_cross_layers=3, hidden=(128, 64)):
    """The JAX ``init_params``' families from ``generator``: cross
    weights normal / sqrt(d0), He-normal deep kernels, an output kernel
    of std 0.01, zero biases; float32, in the module's layouts."""
    d0 = num_fields * embedding_dim + num_dense
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    params = {}
    for i in range(num_cross_layers):
        params["cross_w%d" % i] = normal(d0) / np.sqrt(d0)
        params["cross_b%d" % i] = torch.zeros(d0, device=dev)
    sizes = [d0] + list(hidden)
    for i in range(len(hidden)):
        params["deep_w%d" % i] = normal(sizes[i + 1], sizes[i]) * np.sqrt(
            2.0 / sizes[i])
        params["deep_b%d" % i] = torch.zeros(sizes[i + 1], device=dev)
    params["out_w"] = normal(1, d0 + sizes[-1]) * 0.01
    params["out_b"] = torch.zeros(1, device=dev)
    return params


def forward(params, feats):
    v = feats["emb__" + EMB_TABLE][feats["idx__" + EMB_TABLE]]  # [B,F,k]
    x0 = v.reshape(v.shape[0], -1)
    if feats.get("dense") is not None:
        x0 = torch.cat([x0, feats["dense"]], dim=-1)
    # cross tower: x_{l+1} = x0 * <w_l, x_l> + b_l + x_l
    x = x0
    n_cross = sum(1 for k in params if k.startswith("cross_w"))
    for i in range(n_cross):
        xw = x @ params["cross_w%d" % i]                      # [B]
        x = x0 * xw[:, None] + params["cross_b%d" % i] + x
    # deep tower
    h = x0
    n_deep = sum(1 for k in params if k.startswith("deep_w"))
    for i in range(n_deep):
        h = torch.relu(F.linear(h, params["deep_w%d" % i],
                                params["deep_b%d" % i]))
    out = F.linear(torch.cat([x, h], dim=-1), params["out_w"])
    return out[:, 0] + params["out_b"][0]


def feed(records):
    dense = np.stack([np.asarray(r[0], np.float32) for r in records])
    ids = np.stack([np.asarray(r[1], np.int64) for r in records])
    labels = np.asarray([int(r[2]) for r in records], np.int32)
    return {"dense": dense, "__ids__": {EMB_TABLE: ids}}, labels


def model_spec(num_dense=4, num_fields=8, vocab_size=10000,
               embedding_dim=8, num_cross_layers=3, hidden=(128, 64),
               learning_rate=1e-3):
    del vocab_size  # the PS tables grow lazily; no size is fixed

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, num_dense, num_fields, embedding_dim,
                             num_cross_layers, hidden)
        return DenseParams(params, forward).to(device)

    return ModelSpec(
        name="dcn", init_fn=init_fn,
        apply_fn=lambda module, feats, train: module(feats),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, loss_fn=_ctr.loss_fn,
        optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=_ctr.eval_metrics,
        ps_embedding_infos=[
            {"name": EMB_TABLE, "dim": embedding_dim,
             "initializer": "uniform"},
        ],
        ps_optimizer=("adam", "learning_rate=%g" % learning_rate),
    )


synthetic_data = _ctr.synthetic_data
