"""The port's CTR and census zoo (elasticdl_tpu_torch/models/{wide_deep,
dcn, xdeepfm, census_dnn, census_sqlflow}.py) against the JAX package's,
on the CPU.

Each model gets the same numpy parameters (the JAX init, carried into
the port through ``spec.params_from_jax``), the same feed (the port's
feed makes the JAX feed's ids bit for bit, through the port's copy of
the preprocessing library) and the same pulled embedding rows and index
maps.  The logits, the per-example sigmoid cross entropy, the gradients
of the mean loss with respect to every dense parameter (in the JAX
layouts) and to the rows of every table agree within DeepFM's 2e-5
absolute plus 1e-5 relative (``tests/test_torch_deepfm.py``): float32
sums in other orders.  xDeepFM's CIN needs no more: its two explicit
contractions (``models/xdeepfm.py``) sum each output's 80-160 products
in another order than XLA's einsum, a few float32 ulps.

Then each model trains through each package's in-process PS (two
shards, the spec's native Adam, atomic sync), from the same initial
dense tree and embedding seed: the losses of 4 steps agree within 1e-5
relative and the dense parameters and touched rows on the two PSes
within 1e-5 absolute, the bounds of ``tests/test_torch_ps_trainer.py``.
The last tests are the port's twins of ``tests/test_model_zoo.py``'s
PS-path cases (``:107-203``) under their names.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.models import census_dnn as jcensus_dnn
from elasticdl_tpu.models import census_sqlflow as jcensus_sqlflow
from elasticdl_tpu.models import dcn as jdcn
from elasticdl_tpu.models import wide_deep as jwide_deep
from elasticdl_tpu.models import xdeepfm as jxdeepfm
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu.worker import ps_trainer as jtrainer
from elasticdl_tpu_torch.models import (census_dnn, census_sqlflow, dcn,
                                        wide_deep, xdeepfm)
from elasticdl_tpu_torch.models.spec import load_model_spec, to_jax_layout
from elasticdl_tpu_torch.preprocessing import analyzer_utils
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer
from tests.test_torch_ps_trainer import JAX, PORT, make_client, start_ps

ATOL, RTOL = 2e-5, 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
BATCH, VOCAB = 48, 2000
CTR = dict(num_dense=4, num_fields=10, vocab_size=VOCAB, embedding_dim=8,
           hidden=(32, 16))
CENSUS = dict(embedding_dim=4, hidden=(16,))


def _ctr_records(n, seed):
    dense, ids, labels = jdcn.synthetic_data(
        n=n, num_dense=4, num_fields=10, vocab_size=VOCAB, seed=seed)
    return [(dense[i], ids[i], labels[i]) for i in range(n)]


def _census_rows(n, seed):
    return jwide_deep.synthetic_census_rows(n=n, seed=seed)


def _census_records(n, seed):
    return jcensus_dnn.synthetic_census_records(n=n, seed=seed)


# name -> (JAX spec, port spec, records(n, seed))
MODELS = {
    "wide_deep": (lambda: jwide_deep.model_spec(**CENSUS),
                  lambda: wide_deep.model_spec(**CENSUS), _census_rows),
    "dcn": (lambda: jdcn.model_spec(**CTR), lambda: dcn.model_spec(**CTR),
            _ctr_records),
    "xdeepfm": (lambda: jxdeepfm.model_spec(**CTR),
                lambda: xdeepfm.model_spec(**CTR), _ctr_records),
    "census_dnn": (lambda: jcensus_dnn.model_spec(**CENSUS),
                   lambda: census_dnn.model_spec(**CENSUS),
                   _census_records),
    "census_sqlflow_wide_and_deep": (
        lambda: jcensus_sqlflow.model_spec("wide_and_deep", **CENSUS),
        lambda: census_sqlflow.model_spec("wide_and_deep", **CENSUS),
        _census_records),
    "census_sqlflow_dnn": (
        lambda: jcensus_sqlflow.model_spec("dnn", **CENSUS),
        lambda: census_sqlflow.model_spec("dnn", **CENSUS),
        _census_records),
}


def _jax_params(jspec, seed):
    named, _ = flatten_with_names(jspec.init_fn(jax.random.PRNGKey(seed)))
    return {k: np.array(v) for k, v in named.items()}


def _feed_both(jspec, pspec, records):
    """The two feeds on the same records: ids bit for bit, dense and
    labels equal; returns the JAX feed's (features, labels)."""
    (jf, jl), (pf, pl) = jspec.feed(records), pspec.feed(records)
    assert sorted(pf) == sorted(jf)
    assert sorted(pf["__ids__"]) == sorted(jf["__ids__"])
    for table, ids in jf["__ids__"].items():
        assert pf["__ids__"][table].dtype == ids.dtype, table
        np.testing.assert_array_equal(pf["__ids__"][table], ids,
                                      err_msg=table)
    if "dense" in jf:
        np.testing.assert_array_equal(pf["dense"], jf["dense"])
    np.testing.assert_array_equal(pl, jl)
    return jf, jl


def _rows(spec, features, rng):
    """As the PS trainer feeds a step: each table's unique rows padded to
    the flat id count, [B, F] indices into them."""
    dims = {i["name"]: i["dim"] for i in spec.ps_embedding_infos}
    feats = {k: v for k, v in features.items() if k != "__ids__"}
    rows = {}
    for table, ids in sorted(features["__ids__"].items()):
        uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
        r = np.zeros((ids.size, dims[table]), np.float32)
        r[:uniq.size] = rng.uniform(-0.3, 0.3, (uniq.size, dims[table]))
        rows[table] = r
        feats["idx__" + table] = inverse.reshape(ids.shape).astype(np.int32)
    return feats, rows


def _jax_side(jspec, params, feats, rows, labels):
    def loss_of(params, rows):
        f = dict(feats, **{"emb__" + t: r for t, r in rows.items()})
        logits = jspec.apply_fn(params, f, True)
        per = optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(labels, jnp.float32))
        return per.mean(), (logits, per)

    (_, (logits, per)), (gp, gr) = jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True)(params, rows)
    return (np.asarray(logits), np.asarray(per),
            {k: np.asarray(v) for k, v in gp.items()},
            {k: np.asarray(v) for k, v in gr.items()})


def _port_side(pspec, params, feats, rows, labels):
    module = pspec.init_fn("cpu", 0)
    module.load_state_dict(pspec.params_from_jax(params))
    rows_t = {t: torch.tensor(r, requires_grad=True) for t, r in rows.items()}
    f = {k: torch.from_numpy(v) for k, v in feats.items()}
    f.update({"emb__" + t: r for t, r in rows_t.items()})
    logits = pspec.apply_fn(module, f, True)
    per = pspec.loss_fn(logits, torch.from_numpy(labels))
    per.mean().backward()
    grads = {name: to_jax_layout(p.grad)
             for name, p in module.named_parameters()}
    return (logits.detach().numpy(), per.detach().numpy(), grads,
            {t: r.grad.numpy() for t, r in rows_t.items()})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_gradients_match_jax(name, seed):
    make_j, make_p, records = MODELS[name]
    jspec, pspec = make_j(), make_p()
    params = _jax_params(jspec, seed)
    features, labels = _feed_both(jspec, pspec, records(BATCH, seed))
    feats, rows = _rows(jspec, features, np.random.RandomState(seed))
    want = _jax_side(jspec, params, feats, rows, labels)
    got = _port_side(pspec, params, feats, rows, labels)
    for what, w, g in zip(("logits", "loss"), want[:2], got[:2]):
        assert g.shape == w.shape == (BATCH,), what
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=what)
    assert sorted(got[2]) == sorted(want[2]) == sorted(params)
    for key in want[2]:
        assert got[2][key].shape == want[2][key].shape, key
        np.testing.assert_allclose(got[2][key], want[2][key], atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    assert sorted(got[3]) == sorted(want[3])
    for table in want[3]:
        np.testing.assert_allclose(got[3][table], want[3][table],
                                   atol=ATOL, rtol=RTOL, err_msg=table)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spec_contract_and_parameter_map_match_jax(name):
    make_j, make_p, _ = MODELS[name]
    jspec, pspec = make_j(), make_p()
    assert pspec.name == jspec.name
    assert pspec.ps_embedding_infos == jspec.ps_embedding_infos
    assert pspec.ps_optimizer == jspec.ps_optimizer
    assert sorted(pspec.eval_metrics_fn()) == sorted(jspec.eval_metrics_fn())
    params = _jax_params(jspec, 0)
    module = pspec.init_fn("cpu", 3)
    own = pspec.params_to_jax(module)
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in params.items()}
    module.load_state_dict(pspec.params_from_jax(params))
    back = pspec.params_to_jax(module)
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def _ps_train(pkg, spec, trainer_cls, data, steps=4, **kwargs):
    """``steps`` atomic-sync steps against the package's 2-shard PS;
    returns (losses, dense on the PS, every touched row on the PS)."""
    addrs, servers = start_ps(pkg, spec.ps_optimizer, use_async=False)
    try:
        trainer = trainer_cls(spec, make_client(pkg, addrs),
                              batch_size=32, rng_seed=7, atomic_sync=True,
                              **kwargs)
        losses = [float(trainer.train_minibatch(*data[s % len(data)])[0])
                  for s in range(steps)]
        trainer.close()
        client = make_client(pkg, addrs)
        _, _, dense = client.pull_dense_parameters(-1)
        rows = {}
        for info in spec.ps_embedding_infos:
            t = info["name"]
            ids = np.unique(np.concatenate(
                [f["__ids__"][t].reshape(-1) for f, _ in data]))
            rows[t] = client.pull_embedding_vectors(t, ids, dim=info["dim"])
        return losses, dense, rows
    finally:
        for s in servers:
            s.stop(grace=None)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ps_trajectory_matches_jax_trainer(name):
    make_j, make_p, records = MODELS[name]
    jspec, pspec = make_j(), make_p()
    init = _jax_params(jspec, 7)
    make = pspec.init_fn

    def init_fn(device=None, seed=0):
        module = make(device, seed)
        module.load_state_dict(pspec.params_from_jax(init))
        return module

    pspec = dataclasses.replace(pspec, init_fn=init_fn)
    recs = records(80, 3)       # 32 + 32 + 16: the last batch is padded
    data = [jspec.feed(recs[i:i + 32]) for i in range(0, 80, 32)]
    want = _ps_train(JAX, jspec, jtrainer.ParameterServerTrainer, data)
    got = _ps_train(PORT, pspec, ParameterServerTrainer, data,
                    device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    assert sorted(got[1]) == sorted(want[1])
    for key in want[1]:
        np.testing.assert_allclose(got[1][key], want[1][key],
                                   atol=PARAM_ATOL, err_msg=key)
    for table in want[2]:
        np.testing.assert_allclose(got[2][table], want[2][table],
                                   atol=PARAM_ATOL, err_msg=table)


# -- the twins of tests/test_model_zoo.py's PS-path cases ---------------


def test_load_model_spec_by_short_name():
    for short in ("wide_deep", "dcn", "xdeepfm", "census_dnn",
                  "census_sqlflow", "heart", "iris"):
        spec = load_model_spec(short)
        assert spec.init_fn("cpu", 0) is not None, short
    assert load_model_spec("census_sqlflow", "variant=dnn").name == \
        "census_sqlflow_dnn"
    assert load_model_spec("elasticdl_tpu_torch.models.iris").name == "iris"


@pytest.mark.parametrize("module", [dcn, xdeepfm])
def test_ctr_models_train_through_ps(module):
    spec = module.model_spec(vocab_size=500, embedding_dim=4, hidden=(16,))
    addrs, servers = start_ps(PORT, ("adam", "learning_rate=0.01"), num_ps=1)
    try:
        trainer = ParameterServerTrainer(spec, make_client(PORT, addrs),
                                         batch_size=32, device="cpu")
        dense, ids, labels = module.synthetic_data(n=64, vocab_size=500)
        records = [(dense[i], ids[i], labels[i]) for i in range(64)]
        feats, ys = spec.feed(records[:32])
        loss1, _ = trainer.train_minibatch(feats, ys)
        for _ in range(10):
            loss2, _ = trainer.train_minibatch(feats, ys)
        assert np.isfinite(float(loss2)) and float(loss2) < float(loss1)
        trainer.close()
    finally:
        for s in servers:
            s.stop(grace=None)


def _trains(spec, records):
    addrs, servers = start_ps(PORT, ("adam", "learning_rate=0.01"))
    try:
        trainer = ParameterServerTrainer(spec, make_client(PORT, addrs),
                                         batch_size=32, device="cpu")
        losses = []
        for _ in range(4):
            for i in range(0, 256, 32):
                feats, ys = spec.feed(records[i:i + 32])
                losses.append(float(trainer.train_minibatch(feats, ys)[0]))
        trainer.close()
        return losses
    finally:
        for s in servers:
            s.stop(grace=None)


def test_wide_deep_census_through_ps():
    losses = _trains(wide_deep.model_spec(embedding_dim=4, hidden=(16,)),
                     wide_deep.synthetic_census_rows(n=256))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("make_spec", [
    lambda: census_dnn.model_spec(embedding_dim=4, hidden=(16,)),
    lambda: census_sqlflow.model_spec("wide_and_deep", embedding_dim=4,
                                      hidden=(16,)),
    lambda: census_sqlflow.model_spec("dnn", embedding_dim=4,
                                      hidden=(16,)),
], ids=["census_dnn", "sqlflow_wide_deep", "sqlflow_dnn"])
def test_census_models_train_through_ps(make_spec):
    losses = _trains(make_spec(), census_dnn.synthetic_census_records(n=256))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_census_sqlflow_clause_compiles_to_disjoint_id_spaces():
    groups = census_sqlflow.build_groups()
    # Groups mirror the .sql's three CONCAT clauses.
    assert sorted(groups) == ["group_1", "group_2", "group_3"]
    records = census_dnn.synthetic_census_records(n=64)
    columns = {k: [r[k] for r in records] for k in records[0]}
    jgroups = jcensus_sqlflow.build_groups()
    for name, concat in groups.items():
        ids = concat.transform(columns)
        assert ids.shape == (64, len(concat.columns))
        assert ids.min() >= 0 and ids.max() < concat.num_buckets
        np.testing.assert_array_equal(ids, jgroups[name].transform(columns))
        # Per-field slices live in disjoint offset ranges.
        for j, (col, off) in enumerate(zip(concat.columns, concat.offsets)):
            assert ids[:, j].min() >= off
            assert ids[:, j].max() < off + col.num_buckets


def test_census_dnn_stats_standardization(monkeypatch):
    # Analyzer-exported stats flow into the numeric columns
    # (use_stats=True), the reference's _ELASTICDL_* env scheme.
    monkeypatch.setenv("_EDL_TPU_AGE_AVG", "40")
    monkeypatch.setenv("_EDL_TPU_AGE_STDDEV", "10")
    assert analyzer_utils.get_mean("age") == 40.0
    numeric, _ = census_dnn.build_columns(use_stats=True)
    age = [c for c in numeric if c.key == "age"][0]
    out = age.transform(["50", "30"])
    assert np.allclose(out, [1.0, -1.0])
