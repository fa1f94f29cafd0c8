"""The port's preprocessing library (elasticdl_tpu_torch/preprocessing/)
against the JAX package's, on the CPU: the twins of
``tests/test_preprocessing.py`` and ``tests/test_feature_column.py``
under their names, each also run through the JAX package's layer or
column on the same input.

Integer outputs (hashing, vocabulary lookup, bucketizing, offsets) equal
the JAX package's bit for bit; float outputs agree within 1e-6.  The
layers on the device path take a ``torch.Tensor`` too (``_xp`` sends it
to torch): on a tensor they answer with a tensor whose values are the
numpy path's, ids bit for bit (hashing runs splitmix64 in int64 torch
arithmetic) and floats within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.preprocessing import feature_column as jfc
from elasticdl_tpu.preprocessing import layers as jlayers
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.preprocessing import analyzer_utils
from elasticdl_tpu_torch.preprocessing import feature_column as fc
from elasticdl_tpu_torch.preprocessing import layers
from elasticdl_tpu_torch.preprocessing.feature_column import (
    BucketizedColumn,
    CategoricalHashColumn,
    CategoricalIdentityColumn,
    CategoricalVocabColumn,
    ConcatenatedCategoricalColumn,
    NumericColumn,
    concatenated_categorical_column,
    make_feed,
)
from elasticdl_tpu_torch.preprocessing.layers import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    LogRound,
    Normalizer,
    RaggedBatch,
    RoundIdentity,
    SparseEmbedding,
    ToNumber,
    ToRagged,
    ToSparse,
)
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer
from tests.test_torch_ps_trainer import PORT, make_client, start_ps

FLOAT_TOL = 1e-6


def same_ids(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _both(name, *args, **kwargs):
    """The port's layer and the JAX package's, built alike."""
    return getattr(layers, name)(*args, **kwargs), getattr(jlayers, name)(
        *args, **kwargs)


def test_log_round_reference_example():
    # reference docstring: base=2, [[1.2],[1.6],[0.2],[3.1],[100]]
    #   -> [[0],[1],[0],[2],[7]] (log_round.py:29-40)
    layer, ref = _both("LogRound", num_bins=16, base=2)
    x = np.array([[1.2], [1.6], [0.2], [3.1], [100]])
    out = layer(x)
    np.testing.assert_array_equal(out, [[0], [1], [0], [2], [7]])
    same_ids(out, ref(x))
    same_ids(layer(torch.tensor(x)).numpy(), out)


def test_round_identity_reference_example():
    layer, ref = _both("RoundIdentity", num_buckets=5)
    x = np.array([[1.2], [1.6], [0.2], [3.1], [4.9]])
    out = layer(x)
    np.testing.assert_array_equal(out, [[1], [2], [0], [3], [4]])
    same_ids(out, ref(x))
    same_ids(layer(torch.tensor(x)).numpy(), out)


def test_concatenate_with_offset_reference_example():
    a1 = np.array([[1], [1], [1]])
    a2 = np.array([[2], [2], [2]])
    layer, ref = _both("ConcatenateWithOffset", offsets=[0, 10], axis=1)
    out = layer([a1, a2])
    np.testing.assert_array_equal(out, [[1, 12], [1, 12], [1, 12]])
    same_ids(out, ref([a1, a2]))
    same_ids(layer([torch.from_numpy(a1), torch.from_numpy(a2)]).numpy(),
             out)


def test_discretization():
    layer, ref = _both("Discretization", [0.0, 1.0, 10.0])
    x = np.array([-5.0, 0.5, 5.0, 50.0, 0.0, 1.0, 10.0])
    out = layer(x)
    np.testing.assert_array_equal(out[:4], [0, 1, 2, 3])
    same_ids(out, ref(x))
    # torch.bucketize(right=True) is np.digitize at the boundaries too.
    same_ids(layer(torch.tensor(x, dtype=torch.float32)).numpy(), out)


def test_hashing_deterministic_and_bounded():
    layer, ref = _both("Hashing", num_bins=7)
    ints = layer(np.arange(100))
    assert ((np.asarray(ints) >= 0) & (np.asarray(ints) < 7)).all()
    np.testing.assert_array_equal(layer(np.arange(100)), ints)
    same_ids(ints, ref(np.arange(100)))
    strs = layer(np.array(["cat", "dog", "cat"], dtype=object))
    assert strs[0] == strs[2]
    assert 0 <= strs[1] < 7
    same_ids(strs, ref(np.array(["cat", "dog", "cat"], dtype=object)))


@pytest.mark.parametrize("num_bins,salt", [(7, 0), (64, 3),
                                           (1_000_003, 0), (2**40 + 3, 9)])
def test_hashing_a_tensor_matches_the_host_ids(num_bins, salt):
    """``_xp`` sends a tensor to torch: int64 splitmix64 on the tensor
    equals the JAX package's uint64 numpy ids bit for bit, across the
    whole int64 range (negative ids and the extremes included)."""
    rng = np.random.RandomState(num_bins % 1000)
    x = np.concatenate([
        rng.randint(-2**62, 2**62, size=4096, dtype=np.int64),
        np.arange(-64, 64), [np.iinfo(np.int64).max,
                             np.iinfo(np.int64).min]])
    layer, ref = _both("Hashing", num_bins=num_bins, salt=salt)
    assert layers._xp(torch.from_numpy(x)) is torch
    assert layers._xp(x) is np
    got = layer(torch.from_numpy(x).reshape(-1, 2))
    assert isinstance(got, torch.Tensor)
    same_ids(got.numpy().ravel(), ref(x))
    # A float tensor hashes its values' strings on the host, as the JAX
    # package hashes a float device array's.
    floats = np.array([1.5, -2.25, 3.0], np.float32)
    same_ids(layer(torch.from_numpy(floats)), ref(floats))


def test_index_lookup_with_oov():
    layer, ref = _both("IndexLookup", ["a", "b", "c"])
    x = np.array(["b", "zzz", "a"], dtype=object)
    np.testing.assert_array_equal(layer(x), [1, 3, 0])
    same_ids(layer(x), ref(x))
    assert layer.vocab_size() == ref.vocab_size() == 4


def test_normalizer():
    layer, ref = _both("Normalizer", subtract=2.0, divide=4.0)
    x = np.array([2.0, 6.0, 3.3])
    np.testing.assert_allclose(layer(x)[:2], [0.0, 1.0])
    np.testing.assert_allclose(layer(x), ref(x), atol=FLOAT_TOL, rtol=0)
    got = layer(torch.tensor(x, dtype=torch.float32))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), ref(x), atol=FLOAT_TOL, rtol=0)


def test_to_number_with_defaults():
    layer, ref = _both("ToNumber", out_type=np.float32, default_value=-1)
    x = np.array(["1.5", "", b"2.5", "bad"], dtype=object)
    np.testing.assert_allclose(layer(x), [1.5, -1.0, 2.5, -1.0])
    np.testing.assert_array_equal(layer(x), ref(x))


def test_to_ragged_and_dense_mask():
    rb = ToRagged(sep=",")(["1,2,3", "4", ""])
    assert isinstance(rb, RaggedBatch)
    assert rb.row_lengths.tolist() == [3, 1, 0]
    ids = rb.map_values(lambda v: ToNumber(np.int64)(v))
    dense, mask = ids.to_dense(max_len=3)
    np.testing.assert_array_equal(dense, [[1, 2, 3], [4, 0, 0],
                                          [0, 0, 0]])
    np.testing.assert_array_equal(
        mask, [[1, 1, 1], [1, 0, 0], [0, 0, 0]]
    )
    jdense, jmask = jlayers.ToRagged(sep=",")(["1,2,3", "4", ""]).map_values(
        lambda v: jlayers.ToNumber(np.int64)(v)).to_dense(max_len=3)
    same_ids(dense, jdense)
    np.testing.assert_array_equal(mask, jmask)


def test_to_sparse_shares_representation():
    rb = ToSparse()(["a,b", "c"])
    assert isinstance(rb, RaggedBatch)
    assert [r.tolist() for r in rb.rows()] == [
        r.tolist() for r in jlayers.ToSparse()(["a,b", "c"]).rows()]


def test_ragged_concatenate_with_offset():
    r1 = RaggedBatch.from_rows([[1, 2], [3]])
    r2 = RaggedBatch.from_rows([[5], [6, 7]])
    out = ConcatenateWithOffset(offsets=[0, 10])([r1, r2])
    assert [r.tolist() for r in out.rows()] == [[1, 2, 15], [3, 16, 17]]


@pytest.mark.parametrize("combiner,expect", [
    ("sum", [3.0, 0.0]),
    ("mean", [1.5, 0.0]),
    ("sqrtn", [3.0 / np.sqrt(2), 0.0]),
])
def test_sparse_embedding_combiners(combiner, expect):
    rows = np.array(
        [[[1.0], [2.0], [9.0]], [[9.0], [9.0], [9.0]]], np.float32
    )
    mask = np.array([[1, 1, 0], [0, 0, 0]], np.float32)
    out = SparseEmbedding(combiner)(rows, mask)
    np.testing.assert_allclose(np.asarray(out)[:, 0], expect, rtol=1e-6)
    ref = np.asarray(jlayers.SparseEmbedding(combiner)(rows, mask))
    np.testing.assert_allclose(out, ref, atol=FLOAT_TOL, rtol=0)
    # On tensors: torch ops, and the gradient reaches the rows.
    rows_t = torch.tensor(rows, requires_grad=True)
    got = SparseEmbedding(combiner)(rows_t, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=FLOAT_TOL,
                               rtol=0)
    got.sum().backward()
    assert not rows_t.grad[1].any() and rows_t.grad[0, 0, 0] > 0


def test_analyzer_utils_roundtrip(monkeypatch):
    for key in [k for k in os.environ if k.startswith("_EDL_TPU_")]:
        monkeypatch.delenv(key)
    analyzer_utils.set_stats(
        "age", min=0, max=100, avg=35.5, stddev=10.0,
        count_distinct=77, bucket_boundaries=[10, 20, 30],
    )
    try:
        assert analyzer_utils.get_min("age") == 0
        assert analyzer_utils.get_max("age") == 100
        assert analyzer_utils.get_mean("age") == 35.5
        assert analyzer_utils.get_stddev("age") == 10.0
        assert analyzer_utils.get_distinct_count("age") == 77
        assert analyzer_utils.get_bucket_boundaries("age") == [10, 20, 30]
        assert analyzer_utils.get_min("unknown", default=5) == 5
    finally:
        for key in [k for k in os.environ if k.startswith("_EDL_TPU_")]:
            del os.environ[key]


# -- the twins of tests/test_feature_column.py --------------------------


def test_concatenated_column_offsets_match_reference_example():
    """The reference docstring's worked example: identity(32) +
    vocab(["Private", "Self-emp-inc"]) — second column's ids offset
    by 32."""
    def build(m):
        return m.concatenated_categorical_column([
            m.CategoricalIdentityColumn("id", num_buckets=32),
            m.CategoricalVocabColumn("work_class",
                                     ["Private", "Self-emp-inc"])])

    concat = build(fc)
    assert concat.num_buckets == 32 + 3  # 32 + vocab 2 + oov 1
    record = {"id": [1, 0, 8], "work_class": ["", "Private", "Self-emp-inc"]}
    ids = concat.transform(record)
    assert ids.shape == (3, 2)
    np.testing.assert_array_equal(ids[:, 0], [1, 0, 8])
    # "" -> OOV (=2) + offset 32 = 34; Private -> 0+32; Self-emp-inc -> 1+32
    np.testing.assert_array_equal(ids[:, 1], [34, 32, 33])
    same_ids(ids, build(jfc).transform(record))


def test_hash_and_bucketized_columns():
    h = CategoricalHashColumn("city", 16)
    ids = h.transform(["sf", "nyc", "sf"])
    assert ids.shape == (3,) and (ids < 16).all() and (ids >= 0).all()
    assert ids[0] == ids[2]
    same_ids(ids, jfc.CategoricalHashColumn("city", 16).transform(
        ["sf", "nyc", "sf"]))
    b = BucketizedColumn("age", [25, 50])
    np.testing.assert_array_equal(b.transform([18, 30, 77]), [0, 1, 2])
    same_ids(b.transform([18, 25, 50, 77]),
             jfc.BucketizedColumn("age", [25, 50]).transform(
                 [18, 25, 50, 77]))
    assert b.num_buckets == 3


def test_from_stats_env_plumbing(monkeypatch):
    """An analyzer job exports stats into the env; columns configure
    themselves from them (reference _ELASTICDL_* scheme)."""
    analyzer_utils.set_stats("age", avg=40.0, stddev=10.0,
                             bucket_boundaries=[25, 50])
    analyzer_utils.set_stats("work_class", vocabulary=["a", "b"])
    try:
        n = NumericColumn.from_stats("age")
        np.testing.assert_allclose(n.transform([50.0]), [1.0])
        np.testing.assert_allclose(
            n.transform([50.0, 33.3]),
            jfc.NumericColumn.from_stats("age").transform([50.0, 33.3]),
            atol=FLOAT_TOL, rtol=0)
        b = BucketizedColumn.from_stats("age")
        np.testing.assert_array_equal(b.transform([30.0]), [1])
        v = CategoricalVocabColumn.from_stats("work_class")
        np.testing.assert_array_equal(v.transform(["b", "zz"]), [1, 2])
    finally:
        for k in list(os.environ):
            if k.startswith("_EDL_TPU_"):
                del os.environ[k]


def test_make_feed_emits_framework_convention():
    def feed_of(m):
        return m.make_feed(
            numeric_columns=[m.NumericColumn("hours")],
            id_tables={"emb": m.concatenated_categorical_column([
                m.CategoricalIdentityColumn("id", 8),
                m.CategoricalHashColumn("city", 8)])})

    records = [
        {"hours": 40, "id": 3, "city": "sf", "label": 1},
        {"hours": 20, "id": 5, "city": "nyc", "label": 0},
    ]
    features, labels = feed_of(fc)(records)
    assert features["dense"].shape == (2, 1)
    assert features["__ids__"]["emb"].shape == (2, 2)
    assert (features["__ids__"]["emb"][:, 1] >= 8).all()  # offset applied
    np.testing.assert_array_equal(labels, [1, 0])
    jfeatures, jlabels = feed_of(jfc)(records)
    np.testing.assert_array_equal(features["dense"], jfeatures["dense"])
    same_ids(features["__ids__"]["emb"], jfeatures["__ids__"]["emb"])
    np.testing.assert_array_equal(labels, jlabels)


def test_feature_column_feed_trains_through_ps():
    """End to end: a feature-column feed drives the port's PS embedding
    path (pull unique rows, push sparse grads) for a tiny linear
    model."""
    concat = concatenated_categorical_column([
        CategoricalIdentityColumn("id", 16),
        CategoricalHashColumn("city", 16),
    ])
    feed = make_feed(
        numeric_columns=[NumericColumn("hours")],
        id_tables={"fc_emb": concat},
    )

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1, 2 * 4 + 1))

        def forward(self, feats):
            rows = feats["emb__fc_emb"][feats["idx__fc_emb"]]  # [B,F,4]
            x = torch.cat([rows.reshape(rows.shape[0], -1),
                           feats["dense"]], dim=-1)
            return torch.nn.functional.linear(x, self.w)[:, 0]

    spec = ModelSpec(
        name="fc_linear", init_fn=lambda device=None, seed=0: Linear(),
        apply_fn=lambda module, feats, train: module(feats), feed=feed,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax,
        loss_fn=deepfm.loss_fn,
        ps_embedding_infos=[
            {"name": "fc_emb", "dim": 4, "initializer": "zeros"}
        ],
        ps_optimizer=("sgd", "learning_rate=0.1"),
    )
    addrs, servers = start_ps(PORT, spec.ps_optimizer)
    try:
        trainer = ParameterServerTrainer(spec, make_client(PORT, addrs),
                                         batch_size=4, device="cpu")
        records = [
            {"hours": float(i), "id": i % 16, "city": "c%d" % (i % 3),
             "label": i % 2}
            for i in range(4)
        ]
        features, labels = feed(records)
        loss1, _ = trainer.train_minibatch(features, labels)
        loss2, _ = trainer.train_minibatch(features, labels)
        assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
        assert float(loss2) < float(loss1)  # embeddings + dense learn
        trainer.close()
    finally:
        for s in servers:
            s.stop(grace=None)


def test_vocab_column_handles_bytes_and_nesting_rejected():
    v = CategoricalVocabColumn("w", ["Private", "Self-emp-inc"])
    np.testing.assert_array_equal(
        v.transform([b"Private", "Self-emp-inc", b"zz"]), [0, 1, 2]
    )
    inner = concatenated_categorical_column(
        [CategoricalIdentityColumn("a", 4)]
    )
    with pytest.raises(ValueError, match="nest"):
        ConcatenatedCategoricalColumn(
            [inner, CategoricalIdentityColumn("b", 4)]
        )


def test_hash_column_int_values_vectorized_path():
    h = CategoricalHashColumn("uid", 32)
    ids = h.transform(np.arange(100, dtype=np.int64))
    assert ids.shape == (100,) and (ids < 32).all()
    same_ids(ids, jfc.CategoricalHashColumn("uid", 32).transform(
        np.arange(100, dtype=np.int64)))


def test_layers_on_the_device_path_take_tensors():
    """Every numeric layer of the device path answers a tensor with a
    tensor on its device (torch ops), with the host path's values."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-3, 300, (16, 3))
    t = torch.tensor(x, dtype=torch.float32)
    host = x.astype(np.float32)
    for layer in (Discretization([0.0, 1.0, 10.0, 100.0]),
                  LogRound(num_bins=8, base=2), RoundIdentity(50)):
        got = layer(t)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
        same_ids(got.numpy(), layer(host))
    ids = rng.randint(0, 1000, (16, 3))
    got = Hashing(97)(torch.from_numpy(ids))
    assert isinstance(got, torch.Tensor) and got.device == t.device
    same_ids(got.numpy(), jlayers.Hashing(97)(ids))
    lookup = IndexLookup(["a"])
    same_ids(lookup(["a", "b"]), jlayers.IndexLookup(["a"])(["a", "b"]))
    normal = Normalizer(1.0, 3.0)(t)
    np.testing.assert_allclose(normal.numpy(), (host - 1.0) / 3.0,
                               atol=FLOAT_TOL, rtol=1e-6)
