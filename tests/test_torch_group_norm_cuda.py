"""The GroupNorm CUDA kernel on the card (marked ``cuda``; each test
skips without a card).  This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_group_norm_cuda.py -q

Tolerances as in chip_smoke.py: float32 2e-5 (the two sides reduce in
f32 in different orders), bfloat16 3e-2 (one bf16 rounding apart at
most), statistics 2e-5.
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


def test_resnet50_forward_launches_53_kernels(card):
    module = resnet.model_spec("resnet50", image_size=64).init_fn(card)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    before = gn.LAUNCHES
    with torch.inference_mode():
        module(x.to(card))
    torch.cuda.synchronize()
    assert gn.LAUNCHES - before == 53
