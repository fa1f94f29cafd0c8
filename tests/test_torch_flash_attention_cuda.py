"""The flash attention kernels on the card, forward (B3) and backward (B4
dq, B5 dk/dv) (marked ``cuda``; each test skips without a card).  This
file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_flash_attention_cuda.py -q

Tolerances against the plain version ``_flash_ref`` on the same inputs:
out in float32 2e-5 abs/rel (the JAX oracle's tolerance; sums in other
orders), in bfloat16 2e-2 (the kernel rounds p = exp(s - m) to bf16
against its running row max, the plain version against the final one:
one bf16 rounding of p and one of out apart); m within 1e-5 x max|s|;
l within 2e-5 relative.

The backward kernels against ``_flash_bwd_ref`` on the same residuals
(from the forward kernel) and g, held as chip_smoke.py holds them
(``bwd_errors``): each row's error ||got_r - ref_r|| over the larger of
||ref_r|| and the median row norm, and the tensor's ||got - ref|| /
||ref||.  Limits (row, norm): float32 4e-5, 6e-7 (sums in other orders,
p from exp2 in the kernel); bfloat16 2e-2, 6e-4 (both round ds, p and
the outputs to bf16 from f32 values that differ in their last bits);
about 3x the largest readings on the H100 (chip_smoke.py shows that
they reject a dropped key tile and zeroed rows).  Where a gradient is 0
in exact arithmetic (dq and dk of a one-position sequence: p = 1 and
out = v, so dp = delta), both sides are rounding noise, and the
kernel's must stay under 1e-3 x ||g||.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

OUT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: (4e-5, 6e-7), torch.bfloat16: (2e-2, 6e-4)}


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
    # the edges of the bf16 D=64 kernel's blocks (256 rows, 128 in two-
    # warpgroup builds) and 64-row tiles
    ((2, 4, 1, 64), False, 0),
    ((2, 4, 127, 64), True, 0),
    ((2, 4, 127, 64), False, 0),
    ((2, 4, 129, 64), True, 0),
    ((2, 4, 129, 64), False, 0),
    ((2, 4, 255, 64), True, 0),
    ((2, 4, 257, 64), False, 0),
    ((2, 4, 2048, 64), True, 64),       # a window of one tile
    ((2, 4, 2048, 64), True, 128),      # and of two
])
def test_kernel_matches_plain(card, shape, causal, window, dtype):
    check(*_qkv(shape, card, dtype), causal=causal, window=window)


def test_ring_views_across_block_edges(card):
    """The ring layout's transposed views at a T that ends inside a
    128-row block, causal with windows of one and two tiles and without,
    and non-causal: out is written with q's strides, rows past T
    untouched."""
    q, k, v = _qkv((2, 300, 4, 64), card, torch.bfloat16, seed=11)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for causal, window in ((True, 0), (True, 64), (True, 128),
                           (False, 0)):
        check(qt, kt, vt, causal=causal, window=window)
        out = fa.flash_forward(qt, kt, vt, causal=causal, window=window)[0]
        assert out.stride() == qt.stride()


def test_forward_is_bitwise_deterministic(card):
    """The flagship long prefill (B x H = 128 heads, 16 blocks each): out,
    l and m of two runs give the same bits; every output row has one
    owner."""
    q, k, v = _qkv((8, 16, 2048, 64), card, torch.bfloat16, seed=12)
    first = fa.flash_forward(q, k, v)
    for _ in range(2):
        for a, b in zip(first, fa.flash_forward(q, k, v)):
            assert torch.equal(a, b)


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
    # With grad the Function runs the forward kernel, and its backward
    # the two backward kernels, once each; ``.sum()``'s stride-0 gradient
    # is made contiguous for them.
    q, k, v = _qkv((1, 2, 128, 64), card, torch.float32)
    q.requires_grad_()
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == tuple(
        n + 1 for n in before)
    out, l, m = fa.flash_forward(q.detach(), k, v)
    dq = fa.flash_backward(q.detach(), k, v, out, l, m,
                           torch.ones_like(out))[0]
    assert torch.equal(q.grad, dq)
    with torch.no_grad():
        fa.flash_attention(q, k, v)


def assert_grad_close(got, ref, g, name):
    """Holds a gradient [..., T, D] to its plain version row by row and by
    norm (module docstring); returns (worst row error, norm-relative
    error)."""
    row_tol, norm_tol = BWD_TOL[got.dtype]
    got, ref = got.double().flatten(0, -2), ref.double().flatten(0, -2)
    noise = 1e-3 * float(g.double().norm())
    if float(ref.norm()) < noise:
        assert float(got.norm()) < noise, name
        return 0.0, 0.0
    diff = (got - ref).norm(dim=-1)
    norms = ref.norm(dim=-1)
    row = float((diff / norms.clamp(min=float(norms.median()))).max())
    rel = float(diff.norm() / norms.norm())
    assert row <= row_tol and rel <= norm_tol, (
        "%s: worst row %.3g (limit %g), norm-relative %.3g (limit %g)"
        % (name, row, row_tol, rel, norm_tol))
    return row, rel


def check_bwd(q, k, v, causal, window=0, seed=3):
    """B4 and B5 against ``_flash_bwd_ref`` on the forward kernel's
    residuals and a random g; two runs bitwise equal.  Returns (worst
    row error, norm-relative error) of dq, dk and dv."""
    scale = q.shape[-1] ** -0.5
    gen = torch.Generator(device=q.device).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out, l, m = fa.flash_forward(q, k, v, causal=causal, window=window)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    got = fa.flash_backward(q, k, v, out, l, m, g, causal=causal,
                            window=window)
    again = fa.flash_backward(q, k, v, out, l, m, g, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 2,
                                                         before[1] + 2)
    ref = fa._flash_bwd_ref(q, k, v, out, l, m, g, causal, scale, window)
    errs = []
    for name, x, y, z, src in zip(("dq", "dk", "dv"), got, again, ref,
                                  (q, k, v)):
        assert torch.equal(x, y), name + ": two runs differ"
        assert x.dtype == src.dtype and x.shape == src.shape
        assert x.stride() == src.stride(), name
        assert bool(x.isfinite().all()), name
        errs.append(assert_grad_close(x, z, g, name))
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 4, 2048, 64), True, 0),        # the flagship training shape, cut
    ((2, 3, 256, 64), False, 0),
    ((2, 4, 2048, 64), True, 256),      # window across tiles
    ((2, 2, 384, 64), True, 40),        # window inside one tile
    ((2, 4, 1024, 128), True, 0),       # head_dim 128
    ((2, 4, 1000, 64), True, 0),        # ragged tail tile
    ((1, 2, 77, 128), False, 0),        # ragged, one partial tile
    ((1, 1, 1, 64), True, 0),           # one position
    # the edges of the bf16 D=64 kernels' 128-row blocks and 64-row tiles
    ((2, 4, 1, 64), True, 0),
    ((2, 4, 127, 64), True, 0),
    ((2, 4, 129, 64), False, 0),
    ((2, 4, 129, 64), True, 0),
    ((2, 4, 2048, 64), True, 64),       # a window of one tile
    ((2, 4, 640, 128), True, 200),      # head_dim 128 with a window
])
def test_backward_kernels_match_plain(card, shape, causal, window, dtype):
    check_bwd(*_qkv(shape, card, dtype, seed=4), causal=causal,
              window=window)


def test_backward_takes_ring_layout_views(card):
    """[B, T, H, D] tensors transposed to [B, H, T, D] views, as the
    transformer hands them in: the gradients keep their inputs' strides,
    so the transposes back are views."""
    q, k, v = _qkv((2, 200, 4, 64), card, torch.bfloat16, seed=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    check_bwd(qt, kt, vt, causal=True)
    qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
    gen = torch.Generator(device=card).manual_seed(6)
    g = torch.randn(qt.shape, generator=gen, device=card).to(qt.dtype)
    fa.flash_attention(qt, kt, vt).backward(g)
    out, l, m = fa.flash_forward(qt.detach(), kt.detach(), vt.detach())
    ref = fa._flash_bwd_ref(qt.detach(), kt.detach(), vt.detach(), out, l,
                            m, g, True, 64 ** -0.5)
    for name, got, want in zip(("dq", "dk", "dv"), (qt, kt, vt), ref):
        assert got.grad.transpose(1, 2).is_contiguous()
        assert_grad_close(got.grad, want, g, name)


def test_backward_ring_views_across_block_edges(card):
    """The ring layout's transposed views at a T that ends inside a
    128-row block, causal with a window of one tile and without."""
    q, k, v = _qkv((2, 300, 4, 64), card, torch.bfloat16, seed=7)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for window in (0, 64):
        check_bwd(qt, kt, vt, causal=True, window=window, seed=8)


def test_backward_is_bitwise_deterministic(card):
    """Many blocks of each kernel at once (B x H = 64 heads, 16 blocks
    each): two runs give the same bits, with no atomics to reorder sums."""
    q, k, v = _qkv((4, 16, 2048, 64), card, torch.bfloat16, seed=9)
    gen = torch.Generator(device=card).manual_seed(10)
    g = torch.randn(q.shape, generator=gen, device=card).to(q.dtype)
    out, l, m = fa.flash_forward(q, k, v)
    first = fa.flash_backward(q, k, v, out, l, m, g)
    for _ in range(2):
        again = fa.flash_backward(q, k, v, out, l, m, g)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_outputs_are_deterministic(card):
    q, k, v = _qkv((2, 4, 512, 64), card, torch.bfloat16, seed=2)
    a = fa.flash_forward(q, k, v)
    b = fa.flash_forward(q, k, v)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
