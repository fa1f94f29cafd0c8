"""The unnormalised flash forward kernel B3p (``flash_partial_forward``,
the block step of ring attention) on the card (marked ``cuda``; each test
skips without a card).  This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_flash_partial_cuda.py -q

Tolerances against the plain version ``_partial_ref`` on the same inputs
(``check``): acc is held per row against the row's l, |acc - acc_ref| <=
tol x (l_ref + |acc_ref|), which is the normalised output's tolerance of
the B3 tests (tests/test_torch_flash_attention_cuda.py) carried to the
unnormalised sum: float32 2e-5 (sums in other orders), bfloat16 1e-2 (the
kernel rounds p to bf16 against its running row max before p v, the plain
version keeps p in f32; about 3x the largest reading on the H100,
chip_smoke.py's PARTIAL_TOL).  m within 1e-5 x max|s|; l within 2e-5
relative.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

ACC_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


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
    """B3p against ``_partial_ref`` (acc, l, m)."""
    scale = q.shape[-1] ** -0.5
    before = (fa.LAUNCHES, fa.PARTIAL_LAUNCHES)
    acc, l, m = fa.flash_partial_forward(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.PARTIAL_LAUNCHES) == (before[0], before[1] + 1)
    ref_acc, ref_l, ref_m = fa._partial_ref(q, k, v, causal, scale, 0,
                                            window)
    assert acc.dtype == l.dtype == m.dtype == torch.float32
    assert acc.shape == q.shape and l.shape == m.shape == q.shape[:3]
    tol = ACC_TOL[q.dtype]
    bad = (acc - ref_acc).abs() > tol * (ref_l[..., None] + ref_acc.abs())
    assert not bool(bad.any()), "acc: %d elements off, max abs err %.3g" % (
        int(bad.sum()), float((acc - ref_acc).abs().max()))
    s_max = float((torch.matmul(q.float(), k.float().transpose(-1, -2))
                   * scale).abs().max())
    np.testing.assert_allclose(m.cpu().numpy(), ref_m.cpu().numpy(),
                               atol=1e-5 * s_max, rtol=0)
    np.testing.assert_allclose(l.cpu().numpy(), ref_l.cpu().numpy(),
                               atol=0, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((8, 16, 1024, 64), True, 0),       # the sp=2 ring's diagonal block
    ((8, 16, 1024, 64), False, 0),      # and its lower block
    ((2, 4, 512, 128), True, 0),
    ((2, 4, 512, 128), False, 0),
    ((2, 4, 1024, 64), True, 64),
    ((2, 4, 1024, 64), True, 128),
    ((2, 4, 1, 64), True, 0),
    ((2, 4, 127, 64), True, 0),
    ((2, 4, 129, 64), False, 0),
    ((2, 4, 257, 64), True, 0),
])
def test_partial_kernel_matches_plain(card, shape, causal, window, dtype):
    check(*_qkv(shape, card, dtype), causal=causal, window=window)


def test_partial_kernel_is_bitwise_deterministic(card):
    q, k, v = _qkv((8, 16, 1024, 64), card, torch.bfloat16, seed=4)
    for causal in (True, False):
        first = fa.flash_partial_forward(q, k, v, causal=causal)
        again = fa.flash_partial_forward(q, k, v, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_partial_on_ring_views_normalises_to_the_forward(card):
    """On the ring layout's transposed views, acc / l is B3's output up to
    B3's own rounding of out to bf16."""
    q, k, v = _qkv((2, 300, 4, 64), card, torch.bfloat16, seed=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    check(qt, kt, vt, causal=True)
    acc, l, _ = fa.flash_partial_forward(qt, kt, vt)
    out = fa.flash_forward(qt, kt, vt)[0]
    np.testing.assert_allclose(
        (acc / l[..., None]).to(torch.bfloat16).float().cpu().numpy(),
        out.float().cpu().numpy(), atol=1e-2, rtol=1e-2)


def test_partial_function_backward_on_the_card(card):
    """The Function's backward is plain PyTorch on the card too: its
    gradients equal the same pullback on the CPU copies, up to sums in
    other orders."""
    q, k, v = _qkv((1, 2, 256, 64), card, torch.float32, seed=6)
    rng = np.random.RandomState(7)
    cot = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in ((1, 2, 256, 64), (1, 2, 256), (1, 2, 256))]
    grads = {}
    for dev in (card, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (q, k, v)]
        outs = fa.flash_attention_partial(*leaves, causal=True)
        torch.autograd.backward(outs, [c.to(dev) for c in cot])
        grads[dev.type] = [t.grad.cpu().numpy() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
