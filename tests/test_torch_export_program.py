"""The port's servable program (``elasticdl_tpu_torch/serving/export.py``
and ``loader.py``) on the CPU: twins of tests/test_serving_export.py
and tests/test_serving_loader.py.

A port export carries a weight-free ``torch.export`` program that the
loader runs without the model zoo.  Its predictions are held against
the JAX package's servable (``elasticdl_tpu.serving.loader``, StableHLO)
of the same seeded weights within 1e-4 absolute and relative (the
tolerance of tests/test_torch_serving_parity.py: float32 on both sides,
sums in other orders) for ResNet (resnet_small_cifar10), the MLP,
DeepFM's PS serving bundle and a 2-layer transformer forward.  The
JAX package's GroupNorm runs its plain reference (``ELASTICDL_FUSED_GN=
off``), its attention the plain jnp path, as its own tests run them on
the CPU.
"""

import io
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import deepfm as jdeepfm
from elasticdl_tpu.models import mlp as jmlp
from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.serving.export import export_servable as jax_export
from elasticdl_tpu.serving.loader import load_servable as jax_load
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.models import deepfm
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import group_norm as gn
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import loader as tloader
from tests import torch_serving_zoo as zoo
from tests.test_torch_resnet import random_named

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET = ("resnet", "variant=resnet_small_cifar10")
MLP_ZOO = "tests.torch_export_zoo"


@pytest.fixture(autouse=True)
def plain_jax_group_norm(monkeypatch):
    monkeypatch.setenv("ELASTICDL_FUSED_GN", "off")


def _images(n, seed=3):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(
        np.float32)


def _resnet(seed=0):
    """(JAX spec, JAX params, named weights, port spec, port module)."""
    jspec, params, named = random_named("resnet_small_cifar10", 32,
                                        seed=seed)
    spec = load_model_spec(*RESNET)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    return jspec, params, named, spec, module


@pytest.fixture(scope="module")
def resnet_export(tmp_path_factory):
    """One port export of resnet_small_cifar10 (version 7) and the JAX
    servable of the same weights, shared by the tests that only read
    them: (port dir, manifest, JAX dir, named weights, module)."""
    jspec, params, named, spec, module = _resnet()
    root = tmp_path_factory.mktemp("resnet")
    manifest = texport.export_servable(
        str(root / "port"), RESNET[0], RESNET[1], module, _images(1),
        model_name="rn", version=7)
    jax_export(str(root / "jax"), lambda p, x: jspec.apply_fn(p, x, False),
               params, _images(1), platforms=("cpu",))
    return root / "port", manifest, root / "jax", named, module


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_servable_layout_and_manifest(resnet_export):
    path, manifest, _, named, _ = resnet_export
    files = sorted(os.listdir(path))
    assert files == ["manifest.json", "model.npz", "model.pt2"]
    on_disk = json.loads((path / "manifest.json").read_text())
    assert on_disk == manifest
    assert manifest["format"] == texport.FORMAT
    assert manifest["program"] == "model.pt2"
    assert manifest["version"] == 7 and manifest["model_name"] == "rn"
    assert manifest["polymorphic_batch"] is True
    assert manifest["platforms"] == ["cpu", "cuda"]
    assert manifest["parameters"] == sorted(named)
    assert manifest["input_signature"] == {"shape": [None, 32, 32, 3],
                                           "dtype": "float32"}
    assert manifest["output_signature"] == {"shape": [None, 10],
                                            "dtype": "float32"}
    assert manifest["zoo"] == {"module": RESNET[0],
                               "model_params": RESNET[1]}
    with np.load(path / "model.npz") as z:
        assert sorted(z.files) == sorted(named)
        for name in named:
            np.testing.assert_array_equal(z[name], named[name])
    # The program holds no weights: it is a small fraction of them.
    weights = os.path.getsize(path / "model.npz")
    assert os.path.getsize(path / "model.pt2") < weights / 4


def test_resnet_program_matches_jax_servable_at_any_batch(resnet_export):
    path, _, jax_path, _, _ = resnet_export
    served = tloader.load_servable(str(path), device="cpu")
    assert served.program is not None and served.module is None
    want_model = jax_load(str(jax_path))
    for batch in (1, 3, 8):
        x = _images(batch, seed=batch)
        got = served.predict(x)
        assert got.shape == (batch, 10) and got.dtype == np.float32
        _close(got, want_model.predict(x))


def test_program_route_refuses_inputs_off_the_signature(resnet_export):
    """The loader holds the inputs to the manifest's signature (the
    program's own input check is bypassed: it walks every weight)."""
    served = tloader.load_servable(str(resnet_export[0]), device="cpu")
    with pytest.raises(ValueError, match="servable takes"):
        served.predict(np.zeros((2, 16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="servable takes"):
        served.predict(np.zeros((2, 32, 32), np.float32))


def test_mlp_program_matches_jax_servable(tmp_path):
    sizes = [6, 16, 8, 3]
    params = {k: np.asarray(v) for k, v in jmlp.mlp_init(
        jax.random.PRNGKey(4), sizes).items()}
    x = np.random.RandomState(2).randn(5, 6).astype(np.float32)
    jax_export(str(tmp_path / "jax"), jmlp.mlp_apply, params, x[:1],
               platforms=("cpu",))
    spec = load_model_spec(MLP_ZOO, "sizes=6-16-8-3")
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(params))
    texport.write_servable(str(tmp_path / "port"),
                           texport.ServingFunction(spec, module),
                           spec.params_to_jax(module), x[:1])
    got = tloader.load_servable(str(tmp_path / "port"),
                                device="cpu").predict(x)
    _close(got, jax_load(str(tmp_path / "jax")).predict(x))


def _deepfm_inputs(seed=0, batch=6, fields=5, dim=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 50, (batch, fields))
    uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
    idx = inverse.reshape(ids.shape).astype(np.int32)
    rows = np.zeros((ids.size, dim), np.float32)
    rows[:uniq.size] = rng.uniform(-0.3, 0.3, (uniq.size, dim))
    lin = np.zeros((ids.size, 1), np.float32)
    lin[:uniq.size] = rng.uniform(-0.3, 0.3, (uniq.size, 1))
    return {"dense": rng.randn(batch, 3).astype(np.float32),
            "idx__" + deepfm.EMB_TABLE: idx,
            "idx__" + deepfm.LIN_TABLE: idx,
            "emb__" + deepfm.EMB_TABLE: rows,
            "emb__" + deepfm.LIN_TABLE: lin}


def test_deepfm_ps_bundle_program_matches_jax_servable(tmp_path):
    """DeepFM's serving inputs (features + emb__<table> rows) have
    non-uniform leading dims, so both packages export fixed shapes."""
    kw = dict(num_dense=3, num_fields=5, embedding_dim=4, hidden=(8, 4))
    params = {k: np.asarray(v) for k, v in jdeepfm.init_params(
        jax.random.PRNGKey(1), 3, 5, 4, (8, 4)).items()}
    feats = _deepfm_inputs()
    jspec = jdeepfm.model_spec(**kw)
    jax_export(str(tmp_path / "jax"),
               lambda p, x: jspec.apply_fn(p, x, False), params, feats,
               platforms=("cpu",))
    spec = deepfm.model_spec(**kw)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(params))
    manifest = texport.write_servable(
        str(tmp_path / "port"), texport.ServingFunction(spec, module),
        spec.params_to_jax(module), feats)
    assert manifest["polymorphic_batch"] is False
    assert manifest["output_signature"] == {"shape": [6],
                                            "dtype": "float32"}
    got = tloader.load_servable(str(tmp_path / "port"),
                                device="cpu").predict(feats)
    _close(got, jax_load(str(tmp_path / "jax")).predict(feats))


def _lm(seed=7):
    kw = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
              max_seq_len=32, dtype="float32")
    jcfg = jtfm.TransformerConfig(**kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    named = {k: np.asarray(v)
             for k, v in flatten_with_names(jparams)[0].items()}
    spec = load_model_spec("transformer", ttfm.zoo_params(
        ttfm.TransformerConfig(**kw)))
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(named))
    return jcfg, jparams, spec, module


def test_transformer_forward_program_matches_jax_servable(tmp_path):
    jcfg, jparams, spec, module = _lm()
    toks = np.random.RandomState(1).randint(0, 128, (3, 16)).astype(
        np.int32)
    jax_export(str(tmp_path / "jax"),
               lambda p, x: jtfm.forward(p, x, jcfg), jparams, toks[:1],
               platforms=("cpu",))
    texport.write_servable(str(tmp_path / "port"),
                           texport.ServingFunction(spec, module),
                           spec.params_to_jax(module), toks[:1])
    served = tloader.load_servable(str(tmp_path / "port"), device="cpu")
    assert served.manifest["output_signature"] == {
        "shape": [None, 16, 128], "dtype": "float32"}
    want = jax_load(str(tmp_path / "jax"))
    for batch in (1, 3):
        _close(served.predict(toks[:batch]), want.predict(toks[:batch]))


def _forward_program(path):
    """The forward half of a program file (``serving/export.py``)."""
    archives = texport.program_archives(open(path, "rb").read())
    return torch.export.load(io.BytesIO(archives[texport.FORWARD_PROGRAM]))


def _program_ops(path):
    return [str(n.target) for n in _forward_program(path).graph.nodes
            if n.op == "call_function"]


def test_program_holds_one_custom_op_node_per_kernel_call(resnet_export,
                                                         tmp_path):
    ops = _program_ops(resnet_export[0] / "model.pt2")
    gn_layers = sum(1 for m in load_model_spec(*RESNET).init_fn("cpu")
                    .modules() if type(m).__name__ == "GroupNorm")
    assert gn_layers == 29
    assert ops.count("elasticdl_tpu_torch.group_norm_fwd.default") == 29
    assert not any("native_group_norm" in op or "group_norm.default" == op
                   for op in ops)
    _, _, spec, module = _lm()
    texport.write_servable(str(tmp_path / "lm"),
                           texport.ServingFunction(spec, module),
                           spec.params_to_jax(module),
                           np.zeros((1, 16), np.int32))
    ops = _program_ops(tmp_path / "lm" / "model.pt2")
    assert ops.count("elasticdl_tpu_torch.flash_attention_fwd.default") == 2
    assert not any("softmax" in op for op in ops)


def test_forward_program_copies_nothing_into_the_kernels(resnet_export):
    """The per-request program runs no layout map: every weight goes
    straight into its conv, dense or GroupNorm, and no copy feeds a
    GroupNorm op (its [B, HW, C] view is taken at run time).
    ``chip_smoke.program_census`` is what phase 24 holds the program
    traced on the card to."""
    import chip_smoke

    census = chip_smoke.program_census(torch, str(resnet_export[0]))
    assert census == {"group_norm_ops": 29, "copies_into_group_norm": 0,
                      "layout_ops_on_weights": 0}


@pytest.mark.parametrize("case", ["gn", "gn_relu", "gn_nhwc", "attn",
                                  "attn_window", "attn_ring_layout"])
def test_custom_ops_pass_opcheck(case):
    gen = torch.Generator().manual_seed(0)
    if case.startswith("gn"):
        shape = (2, 3, 4, 8) if case == "gn_nhwc" else (2, 12, 8)
        x = torch.randn(*shape, generator=gen)
        args = (x, torch.randn(8, generator=gen), torch.randn(8, generator=gen),
                4, 1e-6, case == "gn_relu")
        torch.library.opcheck(gn.group_norm_op, args)
        return
    q, k, v = (torch.randn(2, 16, 2, 64, generator=gen) for _ in range(3))
    if case != "attn_ring_layout":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    else:  # the ring layout's [B, T, H, D] -> [B, H, T, D] views
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    window = 4 if case == "attn_window" else 0
    torch.library.opcheck(fa.flash_attention_op,
                          (q, k, v, True, 0.125, window))


def test_custom_ops_equal_the_plain_versions_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 20, 16, generator=gen)
    s, b = torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    for got, want in zip(gn.group_norm_op(x, s, b, 4, 1e-6, True),
                         gn.group_norm_fwd(x, s, b, 4, 1e-6, True)):
        assert torch.equal(got, want)
    q, k, v = (torch.randn(1, 2, 9, 64, generator=gen) for _ in range(3))
    for got, want in zip(fa.flash_attention_op(q, k, v, True, 0.125, 3),
                         fa.flash_forward(q, k, v, True, 0.125, 3)):
        assert torch.equal(got, want)
    # Inference goes through the op; training through the Function.
    with torch.no_grad():
        assert torch.equal(gn.fused_group_norm(x, s, b, 4),
                           gn._group_norm_ref(x, s, b, 4, 1e-6, False))
    xs = x.clone().requires_grad_(True)
    y = gn.fused_group_norm(xs, s, b, 4)
    assert y.grad_fn is not None


def test_dense_overrides_take_precedence(tmp_path):
    spec = load_model_spec("mnist")
    module = spec.init_fn("cpu")
    named = spec.params_to_jax(module)
    name = "Dense_1/bias"
    override = np.full_like(named[name], 0.5)
    x = np.random.RandomState(0).rand(2, 28, 28).astype(np.float32)
    texport.export_servable(
        str(tmp_path / "e"), "mnist", "", module, x[:1],
        dense_overrides={name: override, "not/a/param": np.zeros(3),
                         "Dense_1/kernel": np.zeros((2, 2))})
    with np.load(tmp_path / "e" / "model.npz") as z:
        np.testing.assert_array_equal(z[name], override)
        np.testing.assert_array_equal(z["Dense_1/kernel"],
                                      named["Dense_1/kernel"])
        assert "not/a/param" not in z.files
    module.load_state_dict(spec.params_from_jax(dict(named, **{
        name: override})))
    with torch.inference_mode():
        want = module(torch.from_numpy(x)).numpy()
    got = tloader.load_servable(str(tmp_path / "e"), device="cpu").predict(x)
    _close(got, want)


def test_servable_loads_without_framework(resnet_export, tmp_path):
    """The program route imports neither models/, worker/ nor master/
    (the reference's standalone-loader contract)."""
    path = resnet_export[0]
    x = _images(2)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np\n"
        "from elasticdl_tpu_torch.serving.loader import load_servable\n"
        "m = load_servable(sys.argv[1], device='cpu')\n"
        "np.save(sys.argv[2], m.predict(np.load(sys.argv[3])))\n"
        "bad = sorted(k for k in sys.modules if k.startswith(("
        "'elasticdl_tpu_torch.models', 'elasticdl_tpu_torch.worker', "
        "'elasticdl_tpu_torch.master', 'jax', 'elasticdl_tpu.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, str(path),
                    str(tmp_path / "y.npy"), str(tmp_path / "x.npy")],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    want = tloader.load_servable(str(path), device="cpu").predict(x)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


def test_program_route_refuses_a_broken_program(resnet_export, tmp_path):
    """A program that fails to load raises; the loader does not rebuild
    the module from the zoo in its place."""
    shutil.copytree(resnet_export[0], tmp_path / "e")
    (tmp_path / "e" / "model.pt2").write_bytes(b"not a program")
    with pytest.raises(Exception):
        tloader.load_servable(str(tmp_path / "e"), device="cpu")
    # The zoo route is there only when the caller asks for it.
    served = tloader.load_servable(str(tmp_path / "e"), device="cpu",
                                   zoo=RESNET)
    assert served.program is None and served.module is not None


def test_zoo_route_exports_still_load(resnet_export, tmp_path):
    """An export without a program (as written before the program
    existed: no ``model.pt2``, no ``"program"`` in the manifest) rebuilds
    the module from the manifest's zoo entry."""
    path, _, _, _, module = resnet_export
    shutil.copytree(path, tmp_path / "e")
    os.remove(tmp_path / "e" / "model.pt2")
    manifest = json.loads((tmp_path / "e" / "manifest.json").read_text())
    del manifest["program"]
    (tmp_path / "e" / "manifest.json").write_text(json.dumps(manifest))
    x = _images(3)
    served = tloader.load_servable(str(tmp_path / "e"), device="cpu")
    assert served.program is None and served.module is not None
    with torch.inference_mode():
        _close(served.predict(x), module(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("fmt,ok", [
    ("elasticdl_tpu_torch_servable_v1", True),
    ("int8-weights+elasticdl_tpu_torch_servable_v1", True),
    ("int8-emb+int8-weights+elasticdl_tpu_torch_servable_v1", True),
    ("frame+elasticdl_tpu_torch_servable_v1", False),
    ("sparse-v9+elasticdl_tpu_torch_servable_v1", False),
    ("some_other_format_v1", False),
])
def test_loader_gates_feature_prefixes(tmp_path, fmt, ok):
    zoo.export(tmp_path / "e", {"w": np.eye(4, 2, dtype=np.float32)},
               np.zeros((1, 4), np.float32))
    path = tmp_path / "e" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["format"] = fmt
    path.write_text(json.dumps(manifest))
    if ok:
        tloader.load_servable(str(tmp_path / "e"), device="cpu")
    else:
        with pytest.raises(ValueError, match="known feature prefixes"):
            tloader.load_servable(str(tmp_path / "e"), device="cpu")


def test_tree_inputs_and_outputs_through_the_program(tmp_path):
    """Dict inputs (any key order at predict), a rank-0 per-request
    leaf, and a dict output whose fixed-size leaf keeps its shape."""
    w = np.arange(8, dtype=np.float32).reshape(4, 2)
    zoo.export(tmp_path / "aux", {"w": w},
               {"v": np.zeros((1, 4), np.float32),
                "temp": np.float32(0.0)}, kind="aux")
    served = tloader.load_servable(str(tmp_path / "aux"), device="cpu")
    assert served.manifest["input_signature"] == {
        "v": {"shape": [None, 4], "dtype": "float32"},
        "temp": {"shape": [], "dtype": "float32"}}
    v = np.ones((3, 4), np.float32)
    got = served.predict({"temp": np.float32(2.0), "v": v})
    np.testing.assert_array_equal(got, v @ w * 2.0)
    c = np.arange(8, dtype=np.float32).reshape(4, 2) + 1
    manifest = zoo.export(tmp_path / "auxout", {"w": w, "c": c},
                          np.zeros((4, 4), np.float32), kind="auxout")
    assert manifest["output_signature"] == {
        "y": {"shape": [None, 2], "dtype": "float32"},
        "aux": {"shape": [4, 2], "dtype": "float32"}}
    out = tloader.load_servable(str(tmp_path / "auxout"),
                                device="cpu").predict(v)
    np.testing.assert_array_equal(out["y"], v @ w)
    np.testing.assert_array_equal(out["aux"], c)
