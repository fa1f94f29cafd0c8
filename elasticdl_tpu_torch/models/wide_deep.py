"""Census wide & deep (counterpart of ``elasticdl_tpu/models/wide_deep.py``;
model_zoo/census_wide_deep_model parity), built on the preprocessing
library: Hashing, Discretization and ToNumber make each column's ids and
ConcatenateWithOffset puts them into one id space, the reference's
census feature-engineering pattern.

Works from the census CSV column layout (age, workclass, education, ...,
label) or from the synthetic generator below.  Embeddings are PS-served:
a dim-k deep table and a dim-1 wide (linear) table over one concatenated
id space.  The dense part (the MLP's ``w%d``/``b%d`` and a global
``bias``) keeps the JAX names; a kernel is held ``[out, in]``
(``models/mlp.py``), and ``params_from_jax`` / ``params_to_jax`` map it.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models import deepfm as _ctr
from elasticdl_tpu_torch.models.mlp import DenseParams, mlp_apply, mlp_init
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.preprocessing.layers import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    ToNumber,
)
from elasticdl_tpu_torch.utils.device import resolve_device

DEEP_TABLE = "wide_deep_embedding"
WIDE_TABLE = "wide_deep_linear"

# (name, kind, arg): numeric columns get bucket boundaries, categorical
# columns get a hash-bin count.
CENSUS_FEATURES = [
    ("age", "numeric", [18, 25, 30, 35, 40, 45, 50, 55, 60, 65]),
    ("workclass", "categorical", 64),
    ("education", "categorical", 64),
    ("marital_status", "categorical", 32),
    ("occupation", "categorical", 128),
    ("relationship", "categorical", 32),
    ("race", "categorical", 16),
    ("sex", "categorical", 4),
    ("hours_per_week", "numeric", [20, 30, 40, 50, 60]),
    ("native_country", "categorical", 128),
]


def _field_sizes():
    sizes = []
    for _, kind, arg in CENSUS_FEATURES:
        sizes.append(len(arg) + 1 if kind == "numeric" else arg)
    return sizes


def build_feed():
    """records: list of CSV rows [col0, ..., colN, label]."""
    sizes = _field_sizes()
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    to_number = ToNumber(np.float64, default_value=0)
    transforms = []
    for _, kind, arg in CENSUS_FEATURES:
        if kind == "numeric":
            transforms.append(
                lambda col, d=Discretization(arg): d(to_number(col))
            )
        else:
            transforms.append(Hashing(num_bins=arg))

    def feed(records):
        columns = list(zip(*records))
        id_cols = []
        for i, transform in enumerate(transforms):
            col = np.asarray(columns[i], dtype=object).reshape(-1, 1)
            id_cols.append(np.asarray(transform(col)))
        ids = ConcatenateWithOffset(offsets=offsets, axis=1)(id_cols)
        labels = np.asarray(
            [int(float(v)) for v in columns[-1]], np.int32
        )
        return {"__ids__": {DEEP_TABLE: ids.astype(np.int64),
                            WIDE_TABLE: ids.astype(np.int64)}}, labels

    return feed, int(sum(sizes))


def init_params(generator, num_fields, embedding_dim, hidden=(64, 32)):
    sizes = [num_fields * embedding_dim] + list(hidden) + [1]
    params = mlp_init(sizes, generator)
    params["bias"] = torch.zeros(1, device=generator.device)
    return params


def forward(params, feats):
    deep_v = feats["emb__" + DEEP_TABLE][feats["idx__" + DEEP_TABLE]]
    wide = feats["emb__" + WIDE_TABLE][feats["idx__" + WIDE_TABLE]][
        ..., 0].sum(dim=1)
    x = deep_v.reshape(deep_v.shape[0], -1)
    return wide + mlp_apply(params, x)[:, 0] + params["bias"][0]


def model_spec(embedding_dim=8, hidden=(64, 32), learning_rate=1e-3):
    feed, _ = build_feed()
    num_fields = len(CENSUS_FEATURES)

    def init_fn(device=None, seed=0):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, num_fields, embedding_dim, hidden)
        return DenseParams(params, forward).to(device)

    return ModelSpec(
        name="census_wide_deep", init_fn=init_fn,
        apply_fn=lambda module, feats, train: module(feats),
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, loss_fn=_ctr.loss_fn,
        optimizer=_ctr.adam(learning_rate),
        eval_metrics_fn=_ctr.eval_metrics,
        ps_embedding_infos=[
            {"name": DEEP_TABLE, "dim": embedding_dim,
             "initializer": "uniform"},
            {"name": WIDE_TABLE, "dim": 1, "initializer": "zeros"},
        ],
        ps_optimizer=("adam", "learning_rate=%g" % learning_rate),
    )


def synthetic_census_rows(n=1024, seed=0):
    """CSV-shaped census-like rows with a learnable label rule."""
    rng = np.random.RandomState(seed)
    workclasses = ["private", "gov", "self", "none"]
    educations = ["hs", "college", "masters", "phd", "other"]
    rows = []
    for _ in range(n):
        age = int(rng.randint(17, 80))
        wc = workclasses[rng.randint(len(workclasses))]
        edu = educations[rng.randint(len(educations))]
        marital = ["single", "married", "divorced"][rng.randint(3)]
        occ = "occ%d" % rng.randint(12)
        rel = ["own", "spouse", "child"][rng.randint(3)]
        race = "race%d" % rng.randint(4)
        sex = ["m", "f"][rng.randint(2)]
        hours = int(rng.randint(10, 80))
        country = "c%d" % rng.randint(20)
        score = (
            (age > 35) + (edu in ("masters", "phd")) * 2
            + (hours > 45) + (marital == "married")
        )
        label = int(score + rng.rand() * 1.5 > 3)
        rows.append([
            str(age), wc, edu, marital, occ, rel, race, sex,
            str(hours), country, str(label),
        ])
    return rows
