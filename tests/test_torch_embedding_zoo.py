"""The port's embedding helpers (elasticdl_tpu_torch/models/{embedding,
model_handler, ps_embedding_callback}.py) against the JAX package's, on
the CPU: the twins of ``tests/test_embedding_layer.py``,
``tests/test_model_handler.py`` and ``tests/test_ps_embedding_callback.py``
under their names, each also holding the port to the JAX module where
both can run on the same input.

Tolerances: gathers and combiners within 1e-6 (float32 sums of at most
three rows); placement plans equal; a localized spec's forward against
the JAX localized spec's on the same parameters, and a localized spec's
step-1 loss and dense gradients against the PS spec's on the same table
values, within DeepFM's 2e-5 absolute plus 1e-5 relative
(``tests/test_torch_deepfm.py``); PS rows after a push within 1e-6
relative, as the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models import embedding as jembedding
from elasticdl_tpu.models import model_handler as jhandler
from elasticdl_tpu.models import wide_deep as jwide_deep
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.data.reader import RecioDataReader
from elasticdl_tpu_torch.data.recio_gen import (convert_synthetic_mnist,
                                                decode_xy)
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.models import deepfm, wide_deep
from elasticdl_tpu_torch.models.embedding import (Embedding,
                                                  embedding_feature_column)
from elasticdl_tpu_torch.models.model_handler import (
    localize_spec, plan_embedding_placement)
from elasticdl_tpu_torch.models.ps_embedding_callback import PSEmbedding
from elasticdl_tpu_torch.models.spec import to_jax_layout
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.ps_trainer import (ParameterServerTrainer,
                                                   _pad_host_batch)
from tests.test_torch_ps_trainer import PORT, make_client, start_ps

ATOL, RTOL = 2e-5, 1e-5
DIM = 4


# -- the twins of tests/test_embedding_layer.py -------------------------


def test_embedding_sequence_output():
    layer = Embedding("t", dim=4)
    feats = {}
    layer.collect_ids(feats, np.array([[1, 2], [3, 3]]))
    assert feats["__ids__"]["t"].dtype == np.int64
    rows = np.arange(20, dtype=np.float32).reshape(5, 4)
    idx = np.array([[1, 2], [3, 3]], np.int32)
    out = layer({"emb__t": torch.from_numpy(rows),
                 "idx__t": torch.from_numpy(idx)})
    assert out.shape == (2, 2, 4)
    np.testing.assert_array_equal(out[0, 0].numpy(), rows[1])
    ref = jembedding.Embedding("t", dim=4)({"emb__t": rows, "idx__t": idx})
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_embedding_combiners_with_mask(combiner):
    layer = Embedding("t", dim=2, combiner=combiner)
    rows = np.array([[1.0, 1.0], [3.0, 3.0]], np.float32)
    idx = np.array([[0, 1, 1]], np.int32)
    mask = np.array([[1.0, 1.0, 0.0]], np.float32)  # last id padded out
    rows_t = torch.tensor(rows, requires_grad=True)
    out = layer({"emb__t": rows_t, "idx__t": torch.from_numpy(idx),
                 "mask__t": torch.from_numpy(mask)})
    expect = {"sum": 4.0, "mean": 2.0, "sqrtn": 4.0 / np.sqrt(2)}
    np.testing.assert_allclose(out.detach().numpy()[0, 0], expect[combiner],
                               rtol=1e-6)
    ref = jembedding.Embedding("t", dim=2, combiner=combiner)(
        {"emb__t": rows, "idx__t": idx, "mask__t": mask})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=0)
    # No mask: every id counts; the gradient reaches the gathered rows.
    full = layer({"emb__t": rows_t, "idx__t": torch.from_numpy(idx)})
    np.testing.assert_allclose(
        full.detach().numpy(),
        np.asarray(jembedding.Embedding("t", dim=2, combiner=combiner)(
            {"emb__t": rows, "idx__t": idx})), atol=1e-6, rtol=0)
    full.sum().backward()
    assert (rows_t.grad > 0).all()


def test_feature_column_helper():
    col = embedding_feature_column("age_bucket", vocab_size=11, dim=3)
    assert col.name == "col__age_bucket"
    assert col.vocab_size == 11
    assert col.info["dim"] == 3
    assert col.info == jembedding.embedding_feature_column(
        "age_bucket", vocab_size=11, dim=3).info


def test_recio_gen_roundtrip_through_reader(tmp_path):
    files = convert_synthetic_mnist(str(tmp_path), n=100,
                                    records_per_file=40)
    assert len(files) == 3
    reader = RecioDataReader(str(tmp_path), decode_fn=decode_xy)
    shards = reader.create_shards()
    assert sum(end - start for _, start, end in shards) == 100
    tm = TaskManager(training_shards=shards, records_per_task=40)
    count = 0
    while True:
        task = tm.get(0)
        if task is None:
            break
        for x, y in reader.read_records(task):
            assert x.shape == (28, 28)
            count += 1
        tm.report(task.id, True)
    assert count == 100


# -- the twins of tests/test_model_handler.py ---------------------------


def test_placement_threshold_matches_reference_2mb():
    infos = [
        {"name": "small", "dim": 8},    # 1000*8*4 = 32 KB -> device
        {"name": "big", "dim": 64},     # 10M*64*4 = 2.5 GB -> ps
        {"name": "unknown", "dim": 8},  # no vocab -> ps
        {"name": "edge", "dim": 1},     # exactly 2 MB -> ps
        {"name": "under", "dim": 1},    # 4 bytes under -> device
    ]
    vocab = {"small": 1000, "big": 10_000_000, "edge": 512 * 1024,
             "under": 512 * 1024 - 1}
    plan = plan_embedding_placement(infos, vocab)
    assert plan == {"ps": ["big", "unknown", "edge"],
                    "device": ["small", "under"]}
    assert plan == jhandler.plan_embedding_placement(infos, vocab)


def test_localized_deepfm_trains_without_ps():
    vocab = 500
    spec = deepfm.model_spec(vocab_size=vocab, embedding_dim=4,
                             hidden=(16,))
    local = localize_spec(
        spec, {deepfm.EMB_TABLE: vocab, deepfm.LIN_TABLE: vocab})
    assert local.ps_embedding_infos == []  # everything on device
    trainer = CollectiveTrainer(local, batch_size=32, device="cpu")
    dense, ids, labels = deepfm.synthetic_data(n=64, vocab_size=vocab)
    records = [(dense[i], ids[i], labels[i]) for i in range(64)]
    feats, ys = local.feed(records[:32])
    assert "__ids__" not in feats
    loss1, _ = trainer.train_minibatch(feats, ys)
    for _ in range(15):
        loss2, _ = trainer.train_minibatch(feats, ys)
    assert np.isfinite(float(loss2)) and float(loss2) < float(loss1)
    # The tables are parameters of the module, in the JAX names and
    # layouts ([V, d]) through params_to_jax.
    named = local.params_to_jax(trainer._module)
    assert named["local_emb__" + deepfm.EMB_TABLE].shape == (vocab, 4)
    assert named["local_emb__" + deepfm.LIN_TABLE].shape == (vocab, 1)


def test_hybrid_localization_keeps_big_tables_on_ps():
    spec = deepfm.model_spec(vocab_size=500, embedding_dim=4)
    hybrid = localize_spec(
        spec, {deepfm.LIN_TABLE: 500}, tables=[deepfm.LIN_TABLE]
    )
    names = [i["name"] for i in hybrid.ps_embedding_infos]
    assert names == [deepfm.EMB_TABLE]
    dense, ids, labels = deepfm.synthetic_data(n=8, vocab_size=500)
    records = [(dense[i], ids[i], labels[i]) for i in range(8)]
    feats, _ = hybrid.feed(records)
    assert deepfm.LIN_TABLE not in feats.get("__ids__", {})
    assert deepfm.EMB_TABLE in feats["__ids__"]
    jhybrid = jhandler.localize_spec(
        jdeepfm.model_spec(vocab_size=500, embedding_dim=4),
        {deepfm.LIN_TABLE: 500}, tables=[deepfm.LIN_TABLE])
    jfeats, _ = jhybrid.feed(records)
    assert sorted(feats) == sorted(jfeats)
    np.testing.assert_array_equal(feats["idx__" + deepfm.LIN_TABLE],
                                  jfeats["idx__" + deepfm.LIN_TABLE])


def test_localized_forward_matches_jax_localized_spec():
    """wide & deep with both tables local: the JAX localized tree
    (tables ``[V, d]``) carried by ``params_from_jax`` gives the JAX
    localized forward's logits."""
    _, vocab = wide_deep.build_feed()
    tables = {wide_deep.DEEP_TABLE: vocab, wide_deep.WIDE_TABLE: vocab}
    jspec = jhandler.localize_spec(
        jwide_deep.model_spec(embedding_dim=4, hidden=(16,)), tables)
    pspec = localize_spec(wide_deep.model_spec(embedding_dim=4,
                                               hidden=(16,)), tables)
    named, _ = flatten_with_names(jspec.init_fn(jax.random.PRNGKey(0)))
    params = {k: np.array(v) for k, v in named.items()}
    module = pspec.init_fn("cpu", 0)
    assert sorted(pspec.params_to_jax(module)) == sorted(params)
    module.load_state_dict(pspec.params_from_jax(params))
    rows = wide_deep.synthetic_census_rows(n=32)
    feats, labels = pspec.feed(rows)
    jfeats, _ = jspec.feed(rows)
    want = np.asarray(jspec.apply_fn(params, jfeats, True))
    got = pspec.apply_fn(module, {k: torch.from_numpy(v)
                                  for k, v in feats.items()}, True)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_localized_loss_equals_the_ps_spec_on_the_same_tables():
    """The PS form's first step and the localized form's on the same
    table values (the whole tables pulled from the PS into the local
    parameters) and the same dense parameters: the same loss and dense
    gradients."""
    spec = wide_deep.model_spec(embedding_dim=4, hidden=(16,))
    _, vocab = wide_deep.build_feed()
    rows = wide_deep.synthetic_census_rows(n=32, seed=4)
    features, labels = spec.feed(rows)
    addrs, servers = start_ps(PORT, spec.ps_optimizer)
    try:
        client = make_client(PORT, addrs)
        trainer = ParameterServerTrainer(spec, client, batch_size=32,
                                         device="cpu")
        (padded, ys), weights = _pad_host_batch((features, labels), 32)
        feats, emb, _ = trainer._prepare_embeddings(padded)
        loss, dense_grads, _ = trainer.grad_step(feats, ys, weights, emb)
        full = {i["name"]: client.pull_embedding_vectors(
            i["name"], np.arange(vocab), dim=i["dim"])
            for i in spec.ps_embedding_infos}
        dense = trainer.export_parameters()
        trainer.close()
    finally:
        for s in servers:
            s.stop(grace=None)
    local = localize_spec(spec, {t: vocab for t in full})
    module = local.init_fn("cpu", 0)
    state = local.params_from_jax(dict(
        dense, **{"local_emb__" + t: v for t, v in full.items()}))
    module.load_state_dict(state)
    lfeats, lys = local.feed(rows)
    out = local.apply_fn(module, {k: torch.from_numpy(v)
                                  for k, v in lfeats.items()}, True)
    lloss = local.loss_fn(out, torch.from_numpy(lys)).mean()
    lloss.backward()
    np.testing.assert_allclose(float(lloss.detach()), float(loss), rtol=RTOL)
    params = dict(module.named_parameters())
    # export_parameters and grad_step's gradients are in one order.
    for name, g in zip(dense, dense_grads):
        np.testing.assert_allclose(
            to_jax_layout(params[name].grad), to_jax_layout(g), atol=ATOL,
            rtol=RTOL, err_msg=name)


# -- the twins of tests/test_ps_embedding_callback.py -------------------


def _boot(lr=0.1):
    addrs, servers = start_ps(PORT, ("sgd", "learning_rate=%s" % lr),
                              use_async=True)
    client = make_client(PORT, addrs)
    infos = [{"name": "emb", "dim": DIM, "initializer": "zeros"}]
    client.push_model({"w": np.zeros(1, np.float32)},
                      embedding_infos=infos)
    return client, servers


def _stop(servers):
    for s in servers:
        s.stop(grace=None)


def test_lookup_inside_jit_matches_direct_pull():
    """The port's lookup is an autograd Function called inside the
    forward (there is no jit): it answers a direct pull's rows."""
    client, servers = _boot()
    try:
        client.push_gradients(
            {}, {"emb": (-np.arange(8, dtype=np.float32).reshape(2, DIM),
                         np.array([3, 11], np.int64))}, version=0)
        emb = PSEmbedding(client, "emb", DIM)
        ids = torch.tensor([3, 11, 999])
        got = (emb(ids, emb.handle) * 2.0).detach().numpy()
        want = client.pull_embedding_vectors(
            "emb", np.array([3, 11, 999])) * 2.0
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got.shape == (3, DIM)
    finally:
        _stop(servers)


def test_backward_pushes_sparse_grads_to_ps():
    """The backward through the lookup pushes the sparse gradient to the
    PS: the rows move by -lr * dL/drow (async SGD), duplicate ids merge
    server-side — the reference's tape-rewiring semantics
    (embedding_delegate.py:232-281)."""
    lr = 0.1
    client, servers = _boot(lr=lr)
    try:
        emb = PSEmbedding(client, "emb", DIM)
        ids = torch.tensor([7, 9, 7])  # duplicate id 7 must merge
        handle = emb.handle
        emb(ids, handle).sum().backward()
        rows = client.pull_embedding_vectors("emb", np.array([7, 9]))
        np.testing.assert_allclose(rows[0], -lr * 2.0 * np.ones(DIM),
                                   rtol=1e-6)
        np.testing.assert_allclose(rows[1], -lr * 1.0 * np.ones(DIM),
                                   rtol=1e-6)
        assert float(handle.grad) == 0.0
        # Without a handle that requires grad the tape never reaches the
        # lookup, so nothing is pushed: the handle is needed.
        out = emb(ids, torch.zeros(()))
        assert not out.requires_grad
    finally:
        _stop(servers)


def test_trains_a_model_end_to_end():
    """A tiny regression model whose embedding lives on the PS and
    whose dense weight lives in the step: both learn."""
    client, servers = _boot(lr=0.05)
    try:
        emb = PSEmbedding(client, "emb", DIM)
        ids = torch.tensor([1, 2, 3, 4])
        targets = torch.tensor([1.0, -1.0, 0.5, 2.0])
        params = {"w": torch.ones(DIM, requires_grad=True),
                  "emb_handle": emb.handle}
        first = None
        for _ in range(60):
            rows = emb(ids, params["emb_handle"])
            loss = ((rows @ params["w"] - targets) ** 2).mean()
            if first is None:
                first = float(loss.detach())
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p -= 0.05 * g
        last = float(loss.detach())
        assert last < first * 0.05, (first, last)
    finally:
        _stop(servers)


def test_zoo_placement_plans_match_jax():
    """The placement plan of every model of this slice's zoo, with its
    real vocabulary sizes, is the JAX package's."""
    _, vocab = wide_deep.build_feed()
    spec = wide_deep.model_spec()
    tables = {i["name"]: vocab for i in spec.ps_embedding_infos}
    assert plan_embedding_placement(spec.ps_embedding_infos, tables) == \
        jhandler.plan_embedding_placement(
            jwide_deep.model_spec().ps_embedding_infos, tables)
    big = {deepfm.EMB_TABLE: 100_000, deepfm.LIN_TABLE: 100_000}
    assert plan_embedding_placement(
        deepfm.model_spec().ps_embedding_infos, big) == \
        jhandler.plan_embedding_placement(
            jdeepfm.model_spec().ps_embedding_infos, big) == {
            "ps": [deepfm.EMB_TABLE], "device": [deepfm.LIN_TABLE]}
