"""Pytree features in the port (elasticdl_tpu_torch), held against the
JAX package on the CPU: the trainer pads every leaf of a nested batch as
the JAX trainer's ``_pad_batch`` does, the server writes any output tree
as the JAX server's ``_jsonable`` does, and a model that takes a dict
trains through the port's ``CollectiveTrainer`` and is served over HTTP.

Inputs are made with numpy from a seed.  Padding and JSON are exact, so
they are compared for equality; the trained and served model is held to
1e-6 abs/rel (float32 on the CPU, the same module on both sides).
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdl_tpu.serving import server as jserver
from elasticdl_tpu.worker import collective_trainer as jct
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import server as tserver
from elasticdl_tpu_torch.utils.pytree import (flatten_with_names,
                                              tree_leaves, tree_map)
from elasticdl_tpu_torch.worker import collective_trainer as tct
from tests.test_torch_serving import _Served

VOCAB, CLASSES = 16, 3
ZOO = "tests.test_torch_pytree"   # this module is the zoo entry


def nested_batch(n, seed):
    """A DeepFM-shaped batch: dense features and a nested dict of ids."""
    rng = np.random.RandomState(seed)
    return {"dense": rng.randn(n, 3).astype(np.float32),
            "__ids__": {"a": rng.randint(0, VOCAB, (n, 2)).astype(np.int64),
                        "b": rng.randint(0, VOCAB, (n,)).astype(np.int32)}}


@pytest.mark.parametrize("n", [5, 8])
def test_pad_batch_matches_jax_on_a_nested_dict(n):
    labels = np.random.RandomState(1).randint(0, CLASSES, n)
    batch = (nested_batch(n, seed=11), labels)
    want, want_weights = jct._pad_batch(batch, 8)
    got, weights = tct._pad_batch(tree_map(torch.from_numpy, batch), 8)
    np.testing.assert_array_equal(weights.numpy(), want_weights)
    got_named = flatten_with_names(
        {"x": tree_map(lambda t: t.numpy(), got[0]), "y": got[1].numpy()})
    want_named = flatten_with_names({"x": want[0], "y": np.asarray(want[1])})
    assert sorted(got_named) == sorted(want_named)
    for name, value in want_named.items():
        value = np.asarray(value)
        assert got_named[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got_named[name], value, err_msg=name)
    assert [t.shape[0] for t in tree_leaves(got)] == [8] * 4


def test_jsonable_matches_jax_on_a_nested_output():
    rng = np.random.RandomState(12)
    outputs = {
        "logits": rng.randn(2, 3).astype(np.float32),
        "top": (rng.randint(0, 9, 2), np.int64(4)),
        "meta": {"name": "m", "ok": True, "none": None,
                 "p": np.float32(0.5)},
        "rows": [np.arange(3, dtype=np.int32), 2.5],
    }
    got = json.dumps(tserver._jsonable(outputs), sort_keys=True)
    assert got == json.dumps(jserver._jsonable(outputs), sort_keys=True)
    assert tserver._jsonable(outputs["logits"]) == outputs["logits"].tolist()


class DictNet(torch.nn.Module):
    """Takes {"dense": [B, 4] f32, "ids": [B, 2] int64}; answers
    {"logits": [B, 3], "score": [B]}."""

    def __init__(self):
        super().__init__()
        self.Embed_0 = torch.nn.Embedding(VOCAB, 4)
        self.Dense_0 = torch.nn.Linear(8, CLASSES)

    def forward(self, x):
        embedded = self.Embed_0(x["ids"]).mean(dim=1)
        logits = self.Dense_0(torch.cat([x["dense"], embedded], dim=-1))
        return {"logits": logits, "score": logits.softmax(dim=-1)[:, 0]}


def model_spec(**kwargs):
    def init_fn(device="cuda", seed=0):
        gen = torch.Generator().manual_seed(seed)
        module = DictNet()
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
        return module.to(device)

    return ModelSpec(
        name="dict_net", init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x), feed=None,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax,
        loss_fn=lambda out, y: F.cross_entropy(out["logits"].float(), y,
                                               reduction="none"),
        optimizer=lambda params: torch.optim.SGD(params, lr=0.1))


def dict_batch(n, seed):
    rng = np.random.RandomState(seed)
    return ({"dense": rng.randn(n, 4).astype(np.float32),
             "ids": rng.randint(0, VOCAB, (n, 2)).astype(np.int64)},
            rng.randint(0, CLASSES, n).astype(np.int64))


def test_dict_input_module_trains_and_serves(tmp_path):
    spec = model_spec()
    trainer = tct.CollectiveTrainer(spec, batch_size=4, device="cpu")
    features, labels = dict_batch(3, seed=7)   # a partial batch: padded
    x = tree_map(torch.from_numpy, features)
    with torch.no_grad():
        want_loss = spec.loss_fn(spec.init_fn("cpu", 0)(x),
                                 torch.from_numpy(labels)).mean()
    loss, version = trainer.train_minibatch(features, labels)
    assert version == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert trainer.predict_minibatch(features)["logits"].shape == (
        3, CLASSES)

    texport.export_servable(str(tmp_path / "1"), ZOO, "", trainer.module,
                            tree_map(lambda a: a[:1], features),
                            model_name="dict_net", version=1)
    served = _Served(tserver.ModelEndpoint(str(tmp_path), device="cpu"))
    try:
        body = json.dumps({"inputs": tree_map(lambda a: a.tolist(),
                                              features)})
        status, resp = served.request("POST", "/v1/models/dict_net:predict",
                                      body=body)
    finally:
        served.close()
    assert status == 200, resp
    assert resp["model_version"] == 1
    with torch.no_grad():
        want = trainer.module(x)
    assert sorted(resp["predictions"]) == ["logits", "score"]
    for key in ("logits", "score"):
        np.testing.assert_allclose(np.asarray(resp["predictions"][key]),
                                   want[key].numpy(), atol=1e-6, rtol=1e-6)


def test_dict_features_accumulate_like_one_batch():
    """accum_steps=2 over two microbatches of 4 equals one step over the
    batch of 8: the microbatches are cut from every leaf alike."""
    features, labels = dict_batch(8, seed=9)
    one = tct.CollectiveTrainer(model_spec(), batch_size=8, device="cpu")
    two = tct.CollectiveTrainer(model_spec(), batch_size=4, accum_steps=2,
                                device="cpu")
    loss_one, _ = one.train_minibatch(features, labels)
    loss_two, _ = two.train_minibatch(features, labels)
    np.testing.assert_allclose(float(loss_two), float(loss_one), rtol=1e-6)
    for (name, a), (_, b) in zip(one.module.named_parameters(),
                                 two.module.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
