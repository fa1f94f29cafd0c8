"""The port's DeepFM (elasticdl_tpu_torch/models/deepfm.py) against the
JAX package's (elasticdl_tpu/models/deepfm.py) on the CPU.

Both get the same numpy parameters (the JAX ``init_params`` tree,
carried into the port through ``spec.params_from_jax``) and the same
pulled embedding rows, index maps, dense features and labels.  The
logits, the per-example sigmoid cross entropy, the gradients of the
mean loss with respect to every dense parameter (mapped back to the
JAX layouts) and to the embedding rows of both tables agree within
2e-5 absolute plus 1e-5 relative: float32 sums and matmuls in other
orders.  The synthetic CTR data, the feed and the ``synthetic_ctr``
origin and ``convert_ctr`` records are the JAX package's, value for
value.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.data import factory as jfactory
from elasticdl_tpu.data import recio_gen as jrecio_gen
from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu_torch.data import factory, recio_gen
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models.spec import to_jax_layout

ATOL, RTOL = 2e-5, 1e-5
NUM_DENSE, NUM_FIELDS, DIM, HIDDEN = 4, 10, 8, (32, 16)
BATCH, VOCAB = 48, 2000


def _inputs(seed=0):
    """A batch as the PS trainer feeds it: unique rows of both tables
    padded to the flat id count, [B, F] indices into them."""
    rng = np.random.RandomState(seed)
    dense, ids, labels = jdeepfm.synthetic_data(
        n=BATCH, num_dense=NUM_DENSE, num_fields=NUM_FIELDS,
        vocab_size=VOCAB, seed=seed)
    uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
    rows = np.zeros((ids.size, DIM), np.float32)
    rows[:uniq.size] = rng.uniform(-0.3, 0.3, (uniq.size, DIM))
    lin = np.zeros((ids.size, 1), np.float32)
    lin[:uniq.size] = rng.uniform(-0.3, 0.3, (uniq.size, 1))
    idx = inverse.reshape(ids.shape).astype(np.int32)
    feats = {"dense": dense, "idx__" + deepfm.EMB_TABLE: idx,
             "idx__" + deepfm.LIN_TABLE: idx}
    return feats, rows, lin, labels


def _jax_params(seed=0):
    params = jdeepfm.init_params(jax.random.PRNGKey(seed), NUM_DENSE,
                                 NUM_FIELDS, DIM, HIDDEN)
    return {k: np.array(v) for k, v in params.items()}


def _jax_side(params, feats, rows, lin, labels):
    def loss_of(params, rows, lin):
        f = dict(feats, **{"emb__" + deepfm.EMB_TABLE: rows,
                           "emb__" + deepfm.LIN_TABLE: lin})
        logits = jdeepfm.forward(params, f, True)
        per = optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(labels, jnp.float32))
        return per.mean(), (logits, per)

    (_, (logits, per)), grads = jax.value_and_grad(
        loss_of, argnums=(0, 1, 2), has_aux=True)(params, rows, lin)
    return (np.asarray(logits), np.asarray(per),
            {k: np.asarray(v) for k, v in grads[0].items()},
            np.asarray(grads[1]), np.asarray(grads[2]))


def _port_side(params, feats, rows, lin, labels):
    spec = deepfm.model_spec(num_dense=NUM_DENSE, num_fields=NUM_FIELDS,
                             embedding_dim=DIM, hidden=HIDDEN)
    module = spec.init_fn("cpu", 0)
    module.load_state_dict(spec.params_from_jax(params))
    rows_t = torch.tensor(rows, requires_grad=True)
    lin_t = torch.tensor(lin, requires_grad=True)
    f = {k: torch.from_numpy(v) for k, v in feats.items()}
    f["emb__" + deepfm.EMB_TABLE] = rows_t
    f["emb__" + deepfm.LIN_TABLE] = lin_t
    logits = spec.apply_fn(module, f, True)
    per = spec.loss_fn(logits, torch.from_numpy(labels))
    per.mean().backward()
    grads = {name: to_jax_layout(p.grad)
             for name, p in module.named_parameters()}
    return (logits.detach().numpy(), per.detach().numpy(), grads,
            rows_t.grad.numpy(), lin_t.grad.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_and_gradients_match_jax(seed):
    params = _jax_params(seed)
    inputs = _inputs(seed)
    want = _jax_side(params, *inputs)
    got = _port_side(params, *inputs)
    for name, w, g in zip(("logits", "loss"), want[:2], got[:2]):
        assert g.shape == w.shape == (BATCH,), name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    assert sorted(got[2]) == sorted(want[2])
    for name in want[2]:
        assert got[2][name].shape == want[2][name].shape, name
        np.testing.assert_allclose(got[2][name], want[2][name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    for name, w, g in zip(("embedding rows", "linear rows"), want[3:],
                          got[3:]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        # Rows past the unique ids are padding: no gradient reaches them.
        n_uniq = np.unique(inputs[0]["idx__" + deepfm.EMB_TABLE]).size
        assert not g[n_uniq:].any(), name


def test_parameter_map_round_trips_the_jax_tree():
    params = _jax_params()
    spec = deepfm.model_spec(num_dense=NUM_DENSE, num_fields=NUM_FIELDS,
                             embedding_dim=DIM, hidden=HIDDEN)
    module = spec.init_fn("cpu", 3)
    own = spec.params_to_jax(module)
    assert {k: v.shape for k, v in own.items()} == {
        k: v.shape for k, v in params.items()}
    module.load_state_dict(spec.params_from_jax(params))
    back = spec.params_to_jax(module)
    for name, value in params.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_spec_contract_matches_jax():
    j = jdeepfm.model_spec(embedding_dim=DIM)
    p = deepfm.model_spec(embedding_dim=DIM)
    assert p.ps_embedding_infos == j.ps_embedding_infos
    assert p.ps_optimizer == j.ps_optimizer == ("adam", "learning_rate=0.001")
    assert sorted(p.eval_metrics_fn()) == sorted(j.eval_metrics_fn())
    dense, ids, labels = jdeepfm.synthetic_data(n=16)
    records = [(dense[i], ids[i], labels[i]) for i in range(16)]
    (jf, jl), (pf, pl) = j.feed(records), p.feed(records)
    np.testing.assert_array_equal(pf["dense"], jf["dense"])
    for table in (deepfm.EMB_TABLE, deepfm.LIN_TABLE):
        np.testing.assert_array_equal(pf["__ids__"][table],
                                      jf["__ids__"][table])
    np.testing.assert_array_equal(pl, jl)
    # The evaluation metrics reduce the same outputs to the same values.
    out = np.random.RandomState(0).randn(16).astype(np.float32)
    for name, metric in p.eval_metrics_fn().items():
        ref = j.eval_metrics_fn()[name]
        metric.update(out, labels)
        ref.update(out, labels)
        assert metric.result() == ref.result(), name


def test_synthetic_ctr_origin_and_convert_ctr_match_jax(tmp_path):
    for a, b in zip(deepfm.synthetic_data(n=64, seed=5, vocab_size=VOCAB),
                    jdeepfm.synthetic_data(n=64, seed=5, vocab_size=VOCAB)):
        np.testing.assert_array_equal(a, b)
    ours = factory.create_data_reader("synthetic_ctr:96",
                                      records_per_shard=32)
    ref = jfactory.create_data_reader("synthetic_ctr:96",
                                      records_per_shard=32)
    assert ours.create_shards() == ref.create_shards()
    for name, start, end in ref.create_shards():
        task = types.SimpleNamespace(shard=types.SimpleNamespace(
            name=name, start=start, end=end, record_indices=None))
        got, want = list(ours.read_records(task)), list(
            ref.read_records(task))
        assert len(got) == len(want) == end - start
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    recio_gen.convert_ctr(str(tmp_path / "port"), n=40,
                          records_per_file=16)
    jrecio_gen.convert_ctr(str(tmp_path / "jax"), n=40, records_per_file=16)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    for path in (tmp_path / "jax").iterdir():
        assert (tmp_path / "port" / path.name).read_bytes() == \
            path.read_bytes(), path.name
