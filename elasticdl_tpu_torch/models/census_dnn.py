"""Census DNN (counterpart of ``elasticdl_tpu/models/census_dnn.py``;
model_zoo/census_dnn_model parity).

The reference ships the same census DNN three ways (functional /
sequential / subclass Keras, model_zoo/census_dnn_model/
census_functional_api.py etc.) over a shared feature-column set
(census_feature_columns.py:18-54): 4 numeric features plus 8
categorical features hashed into 64 buckets each and embedded at
dim 16.  The three variants are one module here, as in the JAX package;
the feature-column set is compiled with the declarative feature-column
library (preprocessing/feature_column.py), so all 8 categorical
features share ONE offset id space and one PS-served embedding table.

Records are dicts (column name -> raw value), the natural row shape of
the SQL reader and of CSV-with-header sources.  The dense part (the
MLP's ``w%d``/``b%d``) keeps the JAX names; a kernel is held
``[out, in]`` (``models/mlp.py``).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mlp import DenseParams, mlp_apply, mlp_init
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.utils.device import resolve_device

EMB_TABLE = "census_dnn_embedding"

# census_feature_columns.py:18-33 — the reference's split of the census
# schema into categorical (hash 64 -> embed 16) and numeric keys.
CATEGORICAL_KEYS = [
    "workclass", "education", "marital_status", "occupation",
    "relationship", "race", "sex", "native_country",
]
NUMERIC_KEYS = ["age", "capital_gain", "capital_loss", "hours_per_week"]
HASH_BUCKETS = 64
EMBEDDING_DIM = 16


def build_columns(use_stats=False):
    """Numeric columns (analyzer-standardized when stats are exported)
    plus one concatenated categorical column over all hash spaces."""
    if use_stats:
        numeric = [fc.NumericColumn.from_stats(k) for k in NUMERIC_KEYS]
    else:
        numeric = [fc.NumericColumn(k) for k in NUMERIC_KEYS]
    cat = fc.concatenated_categorical_column(
        [fc.CategoricalHashColumn(k, HASH_BUCKETS)
         for k in CATEGORICAL_KEYS]
    )
    return numeric, cat


def init_params(generator, num_dense, num_fields, embedding_dim,
                hidden=(64, 32)):
    sizes = [num_fields * embedding_dim + num_dense] + list(hidden) + [1]
    return mlp_init(sizes, generator)


def forward(params, feats):
    emb = feats["emb__" + EMB_TABLE][feats["idx__" + EMB_TABLE]]
    x = torch.cat([emb.reshape(emb.shape[0], -1), feats["dense"]], dim=-1)
    return mlp_apply(params, x)[:, 0]


def model_spec(embedding_dim=EMBEDDING_DIM, hidden=(64, 32),
               learning_rate=1e-3, use_stats=False, column_order=""):
    """``column_order``: comma-separated column names for list-shaped
    rows (SQL/CSV sources); empty for dict-shaped records."""
    numeric, cat = build_columns(use_stats=use_stats)
    order = [c for c in column_order.split(",") if c] or None
    feed = fc.make_feed(numeric, {EMB_TABLE: cat}, column_order=order)
    num_fields = len(CATEGORICAL_KEYS)

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, len(numeric), num_fields, embedding_dim,
                             hidden)
        return DenseParams(params, forward).to(device)

    return ModelSpec(
        name="census_dnn", init_fn=init_fn,
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


def synthetic_census_records(n=1024, seed=0):
    """Dict-shaped census-like records with a learnable label rule."""
    rng = np.random.RandomState(seed)
    records = []
    for _ in range(n):
        age = int(rng.randint(17, 80))
        edu = ["hs", "college", "masters", "phd", "other"][
            rng.randint(5)]
        hours = int(rng.randint(10, 80))
        gain = int(rng.choice([0, 0, 0, 5000, 7000, 9000]))
        marital = ["single", "married", "divorced"][rng.randint(3)]
        score = (
            (age > 35) + (edu in ("masters", "phd")) * 2
            + (hours > 45) + (gain > 0) + (marital == "married")
        )
        records.append({
            "age": age,
            "workclass": ["private", "gov", "self", "none"][
                rng.randint(4)],
            "education": edu,
            "marital_status": marital,
            "occupation": "occ%d" % rng.randint(12),
            "relationship": ["own", "spouse", "child"][rng.randint(3)],
            "race": "race%d" % rng.randint(4),
            "sex": ["m", "f"][rng.randint(2)],
            "native_country": "c%d" % rng.randint(20),
            "capital_gain": gain,
            "capital_loss": int(rng.choice([0, 0, 2000])),
            "hours_per_week": hours,
            "label": int(score + rng.rand() * 2 > 4),
        })
    return records
