"""The flash attention forward kernel (B3) on the card (marked ``cuda``;
each test skips without a card).  This file imports no JAX, so it also
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_flash_attention_cuda.py -q

Tolerances against the plain version ``_flash_ref`` on the same inputs:
out in float32 2e-5 abs/rel (the JAX oracle's tolerance; sums in other
orders), in bfloat16 2e-2 (the kernel rounds p = exp(s - m) to bf16
against its running row max, the plain version against the final one:
one bf16 rounding of p and one of out apart); m within 1e-5 x max|s|;
l within 2e-5 relative.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

OUT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, card, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        card, dtype) for _ in range(3)]


def check(q, k, v, causal, window=0):
    """Kernel against ``_flash_ref``; returns out's max abs error."""
    scale = q.shape[-1] ** -0.5
    before = fa.LAUNCHES
    out, l, m = fa.flash_forward(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref_out, ref_l, ref_m = fa._flash_ref(q, k, v, causal, scale, window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert l.dtype == m.dtype == torch.float32
    assert l.shape == m.shape == q.shape[:3]
    tol = OUT_TOL[q.dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref_out.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    s_max = float((torch.matmul(q.float(), k.float().transpose(-1, -2))
                   * scale).abs().max())
    np.testing.assert_allclose(m.cpu().numpy(), ref_m.cpu().numpy(),
                               atol=1e-5 * s_max, rtol=0)
    np.testing.assert_allclose(l.cpu().numpy(), ref_l.cpu().numpy(),
                               atol=0, rtol=2e-5)
    return float((out.float() - ref_out.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 3, 256, 64), True, 0),
    ((2, 3, 256, 64), False, 0),
    ((1, 2, 1000, 64), True, 0),        # ragged tail tile
    ((1, 2, 77, 128), False, 0),        # ragged, one partial tile
    ((2, 2, 384, 64), True, 40),        # window inside one tile
    ((1, 2, 640, 128), True, 200),      # window across tiles
    ((1, 1, 1, 64), True, 0),           # one position
])
def test_kernel_matches_plain(card, shape, causal, window, dtype):
    check(*_qkv(shape, card, dtype), causal=causal, window=window)


def test_ring_layout_views_take_no_copy(card):
    """[B, T, H, D] inputs, transposed to [B, H, T, D] views: the kernel
    reads them by stride and writes an output with q's strides."""
    q, k, v = _qkv((2, 200, 4, 64), card, torch.bfloat16, seed=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    check(qt, kt, vt, causal=True)
    out = fa.flash_attention(qt, kt, vt)
    assert out.stride() == qt.stride()
    assert out.transpose(1, 2).is_contiguous()


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv((1, 2, 128, 32), card, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 128, 64), card, torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 128, 64), card, torch.float32)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        fa.flash_attention(q, k, v)


def test_outputs_are_deterministic(card):
    q, k, v = _qkv((2, 4, 512, 64), card, torch.bfloat16, seed=2)
    a = fa.flash_forward(q, k, v)
    b = fa.flash_forward(q, k, v)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
