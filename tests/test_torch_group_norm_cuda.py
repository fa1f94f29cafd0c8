"""The GroupNorm CUDA kernels on the card (marked ``cuda``; each test
skips without a card).  This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_group_norm_cuda.py -q

Tolerances as in chip_smoke.py: forward float32 2e-5 (the two sides
reduce in f32 in different orders), bfloat16 3e-2 (one bf16 rounding
apart at most), statistics 2e-5; backward float32 3e-5 abs / 3e-4 rel
(the JAX package's gradient tolerance), bfloat16 dx 3e-2, and dscale
and dbias, float32 sums over B x HW terms in either dtype, 1e-4 relative
to their largest entry.

The edge cases of the kernels' plan (``gn.plan``) are held in both
directions: a C that is not a multiple of the 16-byte vector, a
contiguous view whose data pointer is not 16-byte aligned (both take
one channel per access), the float32 stem, whose x and dy overflow one
cluster's shared memory in the backward, B = 1, HW under one block's
rows, and more batch rows than clusters the card holds at once (each
persistent cluster walks several); and ResNet-50 shapes under the plans
the sweep ablates (nothing resident, 8-block clusters, half the shared
memory).
"""

import functools

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models import resnet
from elasticdl_tpu_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, card, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(card) for a in (x, scale, bias)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,groups", [
    ((4, 28 * 28, 128), 32),
    ((2, 36, 8), 4),            # C/G = 2, fewer rows than a chunk
    ((3, 50, 384), 32),         # C over one block of threads, not 2^k
])
def test_kernel_matches_plain(card, shape, groups, dtype, tol):
    x, scale, bias = _inputs(shape, card)
    x = x.to(dtype)
    for relu in (False, True):
        before = gn.LAUNCHES
        got = gn.group_norm_fwd(x, scale, bias, groups, relu=relu)
        torch.cuda.synchronize()
        assert gn.LAUNCHES == before + 1
        want = gn._fwd_ref(x, scale, bias, groups, 1e-6, relu)
        assert got[0].dtype == dtype
        for g, w, t in zip(got, want, (tol, 2e-5, 2e-5)):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(),
                                       atol=t, rtol=t)


def _unaligned(t):
    """The same values in a contiguous view one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _fwd_and_bwd_match_plain(x, dy, scale, bias, groups):
    """Both kernels against their plain versions (ReLU off and on), the
    backward twice and bitwise equal."""
    dtype = x.dtype
    ftol = 2e-5 if dtype == torch.float32 else 3e-2
    btol = (3e-5, 3e-4) if dtype == torch.float32 else (3e-2, 3e-2)
    for relu in (False, True):
        before = (gn.LAUNCHES, gn.BWD_LAUNCHES)
        got = gn.group_norm_fwd(x, scale, bias, groups, relu=relu)
        want = gn._fwd_ref(x, scale, bias, groups, 1e-6, relu)
        for g, w, t in zip(got, want, (ftol, 2e-5, 2e-5)):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(),
                                       atol=t, rtol=t)
        _, mean, rstd = got
        args = (x, dy, scale, bias, mean, rstd, groups, 1e-6, relu)
        bgot = gn.group_norm_bwd(*args)
        again = gn.group_norm_bwd(*args)
        torch.cuda.synchronize()
        assert (gn.LAUNCHES, gn.BWD_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 2)
        for a, b in zip(bgot, again):
            assert torch.equal(a, b), "two runs differ"
        bwant = gn._bwd_ref(*args)
        assert bgot[0].dtype == dtype
        np.testing.assert_allclose(bgot[0].float().cpu().numpy(),
                                   bwant[0].float().cpu().numpy(),
                                   atol=btol[0], rtol=btol[1])
        for g, w in zip(bgot[1:], bwant[1:]):
            w = w.cpu().numpy()
            np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "c12", "unaligned", "stem_f32_rows", "batch1", "short_rows",
    "rows_per_cluster"])
def test_plan_edges_match_plain(card, case, dtype):
    shape, groups = {
        "c12": ((2, 50, 12), 4),          # C not a multiple of 8
        "unaligned": ((2, 36 * 4, 64), 32),
        "stem_f32_rows": ((2, 112 * 112, 64), 32),
        "batch1": ((1, 28 * 28, 128), 32),
        "short_rows": ((3, 5, 384), 32),  # HW under one block's rows
        # more batch rows than clusters the card holds: each walks several
        "rows_per_cluster": ((24, 56 * 56, 256), 32),
    }[case]
    x, scale, bias = _inputs(shape, card)
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(
        np.float32)).to(card, dtype)
    if case == "unaligned":
        x, dy = _unaligned(x), _unaligned(dy)
    p = gn.plan(shape[0], shape[1], shape[2], groups, x.element_size(),
                backward=True, aligned=x.data_ptr() % 16 == 0)
    if case == "unaligned" or (case == "c12" and dtype == torch.bfloat16):
        assert p.vec == 0 and p.resident == 0   # one channel per access
    if case == "stem_f32_rows" and dtype == torch.float32:
        assert 0 < p.resident < p.rows   # x and dy overflow the cluster
    _fwd_and_bwd_match_plain(x, dy, scale, bias, groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("knobs", [
    {"smem_budget": 0}, {"max_cluster": 8}, {"smem_budget": 116 * 1024}],
    ids=["streamed", "cluster8", "half_smem"])
@pytest.mark.parametrize("shape", [(2, 112 * 112, 64), (4, 28 * 28, 512),
                                   (4, 7 * 7, 2048)])
def test_ablation_plans_match_plain(card, monkeypatch, shape, knobs, dtype):
    monkeypatch.setattr(gn, "plan", functools.partial(gn.plan, **knobs))
    x, scale, bias = _inputs(shape, card)
    dy = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(
        np.float32)).to(card, dtype)
    _fwd_and_bwd_match_plain(x.to(dtype), dy, scale, bias, 32)


def test_kernel_refuses_what_it_does_not_take(card):
    x, scale, bias = _inputs((2, 4, 4, 64), card)
    nchw = x.permute(0, 3, 1, 2).contiguous()   # not channels-last
    with pytest.raises(ValueError, match="channels-last"):
        gn.fused_group_norm(nchw.permute(0, 2, 3, 1), scale, bias, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn.fused_group_norm(x.half(), scale, bias, 32)
    with pytest.raises(ValueError, match="not divisible"):
        gn.fused_group_norm(x, scale, bias, 24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((4, 28 * 28, 128), 32),
    ((2, 36, 8), 4),
    ((3, 50, 384), 32),
    ((2, 112 * 112, 64), 32),   # the stem: C/G = 2, many chunks
])
def test_backward_matches_plain_and_is_deterministic(card, shape, groups,
                                                     dtype):
    x, scale, bias = _inputs(shape, card)
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(
        np.float32)).to(card, dtype)
    for relu in (False, True):
        _, mean, rstd = gn.group_norm_fwd(x, scale, bias, groups, relu=relu)
        before = gn.BWD_LAUNCHES
        got = gn.group_norm_bwd(x, dy, scale, bias, mean, rstd, groups,
                                relu=relu)
        again = gn.group_norm_bwd(x, dy, scale, bias, mean, rstd, groups,
                                  relu=relu)
        torch.cuda.synchronize()
        assert gn.BWD_LAUNCHES == before + 2
        for a, b in zip(got, again):
            assert torch.equal(a, b), "two runs differ"
        want = gn._bwd_ref(x, dy, scale, bias, mean, rstd, groups, 1e-6,
                           relu)
        assert got[0].dtype == dtype
        assert got[1].dtype == got[2].dtype == torch.float32
        tol = (3e-5, 3e-4) if dtype == torch.float32 else (3e-2, 3e-2)
        np.testing.assert_allclose(got[0].float().cpu().numpy(),
                                   want[0].float().cpu().numpy(),
                                   atol=tol[0], rtol=tol[1])
        for g, w in zip(got[1:], want[1:]):
            w = w.cpu().numpy()
            np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_autograd_runs_both_kernels(card):
    x, scale, bias = _inputs((2, 8, 8, 64), card)
    x, scale, bias = (t.requires_grad_() for t in (x, scale, bias))
    # The forward kernel alone cannot carry a gradient: with grad enabled
    # it refuses an input that requires one.
    with pytest.raises(RuntimeError, match="no gradient"):
        gn.group_norm_fwd(x.view(2, 64, 64), scale, bias, 32)
    with torch.no_grad():
        gn.group_norm_fwd(x.view(2, 64, 64), scale, bias, 32)
    fwd, bwd = gn.LAUNCHES, gn.BWD_LAUNCHES
    y = gn.fused_group_norm(x, scale, bias, 32, relu=True)
    assert y.grad_fn is not None
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (gn.LAUNCHES - fwd, gn.BWD_LAUNCHES - bwd) == (1, 1)
    assert all(t.grad is not None and bool(t.grad.isfinite().all())
               for t in (x, scale, bias))


def test_resnet_training_gives_every_parameter_a_gradient(card):
    spec = resnet.model_spec("resnet50", image_size=64)
    module = spec.init_fn(card, seed=0)
    # The zero-init head would zero every backbone gradient: random head.
    with torch.no_grad():
        module.Dense_0.weight.normal_(0, 0.05)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    labels = torch.tensor([1, 7], device=card)
    fwd, bwd = gn.LAUNCHES, gn.BWD_LAUNCHES
    loss = spec.loss_fn(spec.apply_fn(module, x.to(card), True),
                        labels).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert (gn.LAUNCHES - fwd, gn.BWD_LAUNCHES - bwd) == (53, 53)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert bool(p.grad.isfinite().all()), name
        assert float(p.grad.abs().max()) > 0, name


def test_resnet50_forward_launches_53_kernels(card):
    module = resnet.model_spec("resnet50", image_size=64).init_fn(card)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    before = gn.LAUNCHES
    with torch.inference_mode():
        module(x.to(card))
    torch.cuda.synchronize()
    assert gn.LAUNCHES - before == 53
