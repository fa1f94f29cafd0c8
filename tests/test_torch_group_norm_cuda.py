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
"""

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
