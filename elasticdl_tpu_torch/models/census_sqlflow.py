"""Census wide & deep / DNN from a declarative COLUMN clause, the
SQLFlow-codegen analog (counterpart of
``elasticdl_tpu/models/census_sqlflow.py``; model_zoo/census_model_sqlflow
parity).

The reference's census_model_sqlflow package is what SQLFlow's code
generator emits for

    SELECT * FROM census_income TO TRAIN WideAndDeepClassifier
    COLUMN EMBEDDING(CONCAT(VOCABULARIZE(workclass),
                            BUCKETIZE(capital_gain, ...), ...) AS group_1, 8),
           ... FOR deep_embeddings
    COLUMN EMBEDDING(group_1, 1), ... FOR wide_embeddings

(census_wide_and_deep.sql; transform graph in feature_configs.py,
transform op vocabulary in transform_ops.py:17-95).  ``CLAUSE`` below is
the parsed COLUMN clause, kept as data: per-feature transforms
(vocabularize / hash / bucketize), CONCAT groups, and per-group
EMBEDDING dims.  ``build_groups`` compiles it onto the declarative
feature-column library (preprocessing/feature_column.py), giving each
group one offset id space and one PS-served embedding table.  Swapping
CLAUSE retargets the model to any schema, the SQLFlow contract; the
model function itself never changes.

Variants: ``wide_and_deep`` (census_model_sqlflow/wide_and_deep) and
``dnn`` (census_model_sqlflow/dnn — deep embeddings only).  The dense
part (the MLP's ``w%d``/``b%d`` and a global ``bias``) keeps the JAX
names; a kernel is held ``[out, in]`` (``models/mlp.py``).
"""

import torch

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mlp import DenseParams, mlp_apply, mlp_init
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.utils.device import resolve_device

# Vocabularies / boundaries the SQLFlow analyzer derives from the data
# (feature_configs.py keeps the census ones inline the same way).
VOCABULARIES = {
    "workclass": ["private", "gov", "self", "none"],
    "marital_status": ["single", "married", "divorced"],
    "relationship": ["own", "spouse", "child"],
    "race": ["race0", "race1", "race2", "race3"],
    "sex": ["m", "f"],
}
BOUNDARIES = {
    "age": [20, 40, 60, 80],
    "capital_gain": [1000, 4000, 6000, 8000],
    "capital_loss": [1000, 2000, 3000],
    "hours_per_week": [10, 20, 30, 40, 50, 60],
}

# The parsed COLUMN clause: group -> list of (op, column) transforms.
# Mirrors census_wide_and_deep.sql's three CONCAT groups verbatim.
CLAUSE = {
    "deep": {
        "group_1": [
            ("vocabularize", "workclass"),
            ("bucketize", "capital_gain"),
            ("bucketize", "capital_loss"),
            ("bucketize", "hours_per_week"),
        ],
        "group_2": [
            ("hash", "education"),
            ("hash", "occupation"),
            ("vocabularize", "marital_status"),
            ("vocabularize", "relationship"),
        ],
        "group_3": [
            ("bucketize", "age"),
            ("hash", "native_country"),
            ("vocabularize", "race"),
            ("vocabularize", "sex"),
        ],
    },
    # The .sql wide clause embeds groups 1 and 2 at dim 1.
    "wide": ["group_1", "group_2"],
}
HASH_BUCKETS = {"education": 30, "occupation": 30, "native_country": 100}


def _leaf_column(op, key):
    if op == "vocabularize":
        return fc.CategoricalVocabColumn(key, VOCABULARIES[key])
    if op == "hash":
        return fc.CategoricalHashColumn(key, HASH_BUCKETS[key])
    if op == "bucketize":
        return fc.BucketizedColumn(key, BOUNDARIES[key])
    raise ValueError("unknown transform op %r" % op)


def build_groups(clause=None):
    """Compile the clause's CONCAT groups into concatenated columns."""
    clause = clause or CLAUSE
    return {
        name: fc.concatenated_categorical_column(
            [_leaf_column(op, key) for op, key in transforms]
        )
        for name, transforms in clause["deep"].items()
    }


def _table(group, role):
    return "census_sqlflow_%s_%s" % (group, role)


def init_params(generator, fields_per_group, embedding_dim,
                hidden=(64, 32)):
    d0 = sum(fields_per_group) * embedding_dim
    params = mlp_init([d0] + list(hidden) + [1], generator)
    params["bias"] = torch.zeros(1, device=generator.device)
    return params


def make_forward(group_names, wide_groups):
    def forward(params, feats):
        deep_parts = []
        for g in group_names:
            t = _table(g, "deep")
            rows = feats["emb__" + t][feats["idx__" + t]]
            deep_parts.append(rows.reshape(rows.shape[0], -1))
        x = torch.cat(deep_parts, dim=-1)
        logit = mlp_apply(params, x)[:, 0] + params["bias"][0]
        for g in wide_groups:
            t = _table(g, "wide")
            logit = logit + feats["emb__" + t][feats["idx__" + t]][
                ..., 0].sum(dim=1)
        return logit

    return forward


def model_spec(variant="wide_and_deep", embedding_dim=8,
               hidden=(64, 32), learning_rate=1e-3, clause=None,
               column_order=""):
    """``column_order``: comma-separated column names for list-shaped
    rows (SQL/CSV sources); empty for dict-shaped records."""
    clause = clause or CLAUSE
    groups = build_groups(clause)
    group_names = sorted(groups)
    wide_groups = list(clause["wide"]) if variant == "wide_and_deep" \
        else []

    # One PS table per (group, role); wide tables are dim-1 linear
    # weights over the same id space (EMBEDDING(group, 1) in the .sql).
    id_tables = {}
    infos = []
    for g in group_names:
        id_tables[_table(g, "deep")] = groups[g]
        infos.append({"name": _table(g, "deep"), "dim": embedding_dim,
                      "initializer": "uniform"})
    for g in wide_groups:
        id_tables[_table(g, "wide")] = groups[g]
        infos.append({"name": _table(g, "wide"), "dim": 1,
                      "initializer": "zeros"})
    order = [c for c in column_order.split(",") if c] or None
    feed = fc.make_feed([], id_tables, column_order=order)
    fields = [len(groups[g].columns) for g in group_names]
    forward = make_forward(group_names, wide_groups)

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, fields, embedding_dim, hidden)
        return DenseParams(params, forward).to(device)

    return ModelSpec(
        name="census_sqlflow_%s" % variant, init_fn=init_fn,
        apply_fn=lambda module, feats, train: module(feats),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, loss_fn=_ctr.loss_fn,
        optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=_ctr.eval_metrics,
        ps_embedding_infos=infos,
        ps_optimizer=("adam", "learning_rate=%g" % learning_rate),
    )
