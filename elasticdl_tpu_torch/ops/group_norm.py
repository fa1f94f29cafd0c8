"""GroupNorm + affine (+ ReLU): the CUDA kernels, their wrappers and the
autograd Function that joins them.

Counterpart of ``elasticdl_tpu/ops/group_norm.py``.  Two kernels, both
bound by device-memory bytes (each source's header says how its design
splits the work across the card):

 - forward, ``csrc/group_norm.cu``, replaces the TPU kernel
   ``_fwd_kernel`` (launched by ``_fwd_pallas``);
 - backward, ``csrc/group_norm_bwd.cu``, replaces ``_bwd_kernel``
   (launched by ``_bwd_pallas``).

Both hold a batch row in one thread-block cluster's shared memory where
it fits.  ``plan`` chooses, per shape, the cluster size, the rows per
block, how many of them stay resident in shared memory and the bytes
that takes; it is a pure function of the shape, so the CPU tests hold
its arithmetic, and the C entry points refuse a plan whose layout they
compute differently.

``_FusedGroupNorm`` is the counterpart of the ``custom_vjp`` ``_fused``:
its forward saves x, scale, bias and the f32 mean and rstd (never y) and
its backward is the backward kernel.  ``fused_group_norm`` goes through
it whenever grad is enabled and an input requires it; otherwise it calls
the forward alone, as the custom op ``group_norm_op``
(``elasticdl_tpu_torch::group_norm_fwd``), and saves nothing: that op is
what ``torch.export`` captures in a servable program
(``serving/export.py``).

Layout: channels-last ``[..., C]``; statistics per group over
(spatial..., C/G), as flax.linen.GroupNorm computes them, with the
variance centered.  ``eps`` defaults to flax's 1e-6, not torch's 1e-5.

Dispatch is by the tensor's device alone: a CPU tensor goes through the
plain PyTorch versions (``_fwd_ref``, ``_bwd_ref``); a CUDA tensor
launches the kernel or raises.  There is no switch to the plain version
on the card.  ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches;
``DY_COPIES`` counts backward calls whose incoming gradient was not
contiguous channels-last and had to be copied.
"""

import collections
import ctypes
import functools

import torch

from elasticdl_tpu_torch.ops import build

LAUNCHES = 0
BWD_LAUNCHES = 0
DY_COPIES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' limits (csrc/gn_common.cuh): threads per block, blocks per
# cluster (above 8 a non-portable size), resident pieces (one mbarrier
# each), and the shared memory one block may use on an H100 (227 KB).
THREADS = 256
MAX_CLUSTER = 16
MAX_PIECES = 8
SMEM_MAX = 232448
# Bytes of resident rows per piece of the copy: a piece's first pass
# starts while later pieces land, but each piece costs a barrier wait in
# the first pass and a block-wide barrier in the second.
PIECE_BYTES = 32768
# Blocks a call aims for: about one per SM of the H100's 132, so small
# rows are spread over the card in one wave.
TARGET_BLOCKS = 128

Plan = collections.namedtuple(
    "Plan", "rows cluster resident pieces vec smem workspace")
Plan.__doc__ = """One call's launch plan: ``rows`` per block, ``cluster``
blocks per batch row (ceil(HW / rows)), ``resident`` of each block's rows
held in shared memory (copied in ``pieces`` pieces), ``vec`` 1 for
16-byte accesses, ``smem`` dynamic shared bytes per block, ``workspace``
float32 elements of scratch (the backward's per-(batch, channel) sums)."""


def _floats(C, G, K, lanes, backward):
    """Float32 buffers of one block (``gn::floats_of``)."""
    cpg = C // G
    floats = 2 * lanes * C                      # per-lane channel sums
    if backward:
        own = -(-G // K) * cpg                  # channels a rank owns
        return floats + 2 * K * own + 2 * G     # received sums, group means
    # shifts, partials (two batch rows' worth), group statistics
    return floats + G + 6 * K * G + 2 * G


def _smem_bytes(C, G, K, rr, pieces, esize, vec_elems, backward):
    """Dynamic shared bytes of one block (``gn::smem_bytes``): resident
    rows of x (and dy), the float32 buffers, one mbarrier per piece."""
    lanes = THREADS // min(C // vec_elems, THREADS)
    data = rr * C * esize * (2 if backward else 1)
    floats = _floats(C, G, K, lanes, backward) * 4
    return data + -(-floats // 8) * 8 + 8 * pieces


@functools.lru_cache(maxsize=4096)
def plan(B, HW, C, G, esize, backward, aligned=True,
         max_cluster=MAX_CLUSTER, target_blocks=TARGET_BLOCKS,
         smem_budget=SMEM_MAX, piece_bytes=PIECE_BYTES):
    """The launch plan for x [B, HW, C] of ``esize``-byte elements, G
    groups.  ``aligned``: every tensor the kernel reads or writes in
    vectors starts on 16 bytes.  The cluster size is a power of two (a
    GPC of the H100 holds two 8-block or one 16-block cluster of blocks
    that each fill an SM): the smallest that gives ``target_blocks``
    blocks or, failing that, holds the whole row in ``smem_budget``
    bytes per block, up to ``max_cluster``; rows that do not fit are
    read from device memory by both passes.  The resident rows are
    copied in pieces of about ``piece_bytes``, at most MAX_PIECES.
    ``max_cluster``, ``target_blocks``, ``smem_budget`` (0: nothing
    resident) and ``piece_bytes`` exist for the ablations of
    ``scripts/sweep_group_norm.py``.  Remembered per argument tuple: it
    runs on every call of the kernels."""
    vec = aligned and (C * esize) % 16 == 0
    vec_elems = 16 // esize if vec else 1
    row_bytes = C * esize * (2 if backward else 1)
    keep = vec and smem_budget > 0

    def fits(K):
        R = -(-HW // K)
        return _smem_bytes(C, G, K, R, min(MAX_PIECES, R), esize, vec_elems,
                           backward) <= smem_budget

    K = 1
    while 2 * K <= max_cluster and K < HW and (
            K * B < target_blocks or (keep and not fits(K))):
        K *= 2
    R = -(-HW // K)
    K = -(-HW // R)
    rr = 0
    if keep:
        free = min(smem_budget, SMEM_MAX) - _smem_bytes(
            C, G, K, 0, MAX_PIECES, esize, vec_elems, backward)
        rr = max(0, min(R, free // row_bytes))
    pieces = min(MAX_PIECES, rr, -(-rr * row_bytes // piece_bytes))
    return Plan(R, K, rr, pieces, int(vec),
                _smem_bytes(C, G, K, rr, pieces, esize, vec_elems, backward),
                2 * B * C if backward else 0)


def _fwd_ref(x3, scale, bias, num_groups, eps, relu):
    """Plain PyTorch version of the kernel.  x3 [B, HW, C] -> (y in x's
    dtype, mean [B, 1, C] f32, rstd [B, 1, C] f32)."""
    B, HW, C = x3.shape
    cpg = C // num_groups
    xf = x3.float().reshape(B, HW, num_groups, cpg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean) * rstd).reshape(B, HW, C) * scale.float() \
        + bias.float()
    if relu:
        y = torch.relu(y)

    def per_channel(stat):
        return stat.expand(B, 1, num_groups, cpg).reshape(B, 1, C)

    return y.to(x3.dtype), per_channel(mean), per_channel(rstd)


def _group_norm_ref(x, scale, bias, num_groups, eps, relu):
    """Plain PyTorch version of ``fused_group_norm`` (the math of the JAX
    ``_group_norm_ref``)."""
    B, C = x.shape[0], x.shape[-1]
    y3 = _fwd_ref(x.reshape(B, -1, C), scale, bias, num_groups, eps,
                  relu)[0]
    return y3.reshape(x.shape)


def _bwd_ref(x3, dy3, scale, bias, mean, rstd, num_groups, eps, relu):
    """Plain PyTorch version of the backward kernel: the closed form of
    the JAX ``_bwd_kernel``, written out (not autograd of ``_fwd_ref``).
    -> (dx in x's dtype, dscale [C] f32, dbias [C] f32).

    The ReLU mask is the forward kernel's decision: a and b are formed
    as the kernel forms them, and the sign of x * a + b is taken in
    float64, where the product of two float32 values is exact, so it is
    the sign of the kernel's fma.  ``eps`` is unused (rstd carries it);
    it is kept so both directions take the same arguments."""
    del eps
    B, HW, C = x3.shape
    cpg = C // num_groups
    xf, dy = x3.float(), dy3.float()
    scale = scale.float()
    if relu:
        a = rstd * scale
        b = bias.float() - mean * a
        dy = torch.where(xf.double() * a.double() + b.double() > 0, dy,
                         torch.zeros_like(dy))
    xhat = (xf - mean) * rstd
    s1 = dy.sum(dim=1, keepdim=True)                      # [B, 1, C]
    s2 = (dy * xhat).sum(dim=1, keepdim=True)

    def group_mean(v):
        g = v.reshape(B, 1, num_groups, cpg).sum(dim=3, keepdim=True)
        return (g / (HW * cpg)).expand(B, 1, num_groups, cpg).reshape(
            B, 1, C)

    dx = rstd * (dy * scale - group_mean(s1 * scale)
                 - xhat * group_mean(s2 * scale))
    return dx.to(x3.dtype), s2.sum(dim=(0, 1)), s1.sum(dim=(0, 1))


def bind_fwd(lib):
    """Declares the forward library's C interface to ctypes."""
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.edl_group_norm_fwd.argtypes = [ptr] * 6 + [cint] * 9 + [
        ctypes.c_float, cint, cint, ptr]
    lib.edl_group_norm_fwd.restype = cint
    lib.edl_group_norm_fwd_max_clusters.argtypes = [cint] * 4
    lib.edl_group_norm_fwd_max_clusters.restype = cint
    return lib


def bind_bwd(lib):
    """Declares the backward library's C interface to ctypes."""
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.edl_group_norm_bwd.argtypes = [ptr] * 10 + [cint] * 11 + [ptr]
    lib.edl_group_norm_bwd.restype = cint
    lib.edl_group_norm_bwd_max_clusters.argtypes = [cint] * 4
    lib.edl_group_norm_bwd_max_clusters.restype = cint
    return lib


@functools.cache
def _library():
    return bind_fwd(build.library("group_norm"))


@functools.cache
def _bwd_library():
    return bind_bwd(build.library("group_norm_bwd"))


def _check_affine(x3, scale, bias):
    C = x3.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (C,) or t.device != x3.device:
            raise ValueError("%s must be [%d] on %s, got %s on %s" % (
                name, C, x3.device, tuple(t.shape), t.device))
    return (scale.to(torch.float32).contiguous(),
            bias.to(torch.float32).contiguous())


def _check_x3(x3, what="x"):
    if x3.dtype not in _DTYPES:
        raise TypeError("group_norm kernel takes float32 or bfloat16, "
                        "got %s" % x3.dtype)
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(
            "group_norm kernel takes a contiguous channels-last "
            "[B, HW, C] %s (keep activations in torch.channels_last); "
            "got shape %s strides %s" % (what, tuple(x3.shape),
                                         x3.stride()))


def _fwd_cuda(x3, scale, bias, num_groups, eps, relu):
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x3, scale, bias)):
        raise RuntimeError(
            "group_norm_fwd's output carries no gradient; with grad "
            "enabled, call fused_group_norm (its autograd Function "
            "pairs this kernel with the backward kernel)")
    _check_x3(x3)
    B, HW, C = x3.shape
    scale, bias = _check_affine(x3, scale, bias)
    p = plan(B, HW, C, num_groups, x3.element_size(), backward=False,
             aligned=x3.data_ptr() % 16 == 0)
    lib = _library()
    y = torch.empty_like(x3)
    mean = torch.empty((B, 1, C), dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x3.device):
        err = lib.edl_group_norm_fwd(
            x3.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), B, HW, C,
            num_groups, p.rows, p.resident, p.pieces, p.vec, p.smem,
            float(eps), int(bool(relu)), _DTYPES[x3.dtype],
            torch.cuda.current_stream(x3.device).cuda_stream)
    if err:
        raise RuntimeError(
            "group_norm kernel launch failed (cudaError_t %d) for "
            "B=%d HW=%d C=%d G=%d, %s" % (err, B, HW, C, num_groups, p))
    LAUNCHES += 1
    return y, mean, rstd


def _bwd_cuda(x3, dy3, scale, bias, mean, rstd, num_groups, relu):
    global BWD_LAUNCHES
    _check_x3(x3)
    _check_x3(dy3, "dy")
    if dy3.shape != x3.shape or dy3.dtype != x3.dtype:
        raise ValueError("dy must match x: got %s %s for %s %s" % (
            tuple(dy3.shape), dy3.dtype, tuple(x3.shape), x3.dtype))
    B, HW, C = x3.shape
    scale, bias = _check_affine(x3, scale, bias)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.shape != (B, 1, C) or t.dtype != torch.float32
                or t.device != x3.device or not t.is_contiguous()):
            raise ValueError(
                "%s must be contiguous float32 [%d, 1, %d] on %s, got %s "
                "%s on %s" % (name, B, C, x3.device, tuple(t.shape),
                              t.dtype, t.device))
    p = plan(B, HW, C, num_groups, x3.element_size(), backward=True,
             aligned=x3.data_ptr() % 16 == 0 and dy3.data_ptr() % 16 == 0)
    lib = _bwd_library()
    dx = torch.empty_like(x3)
    dscale = torch.empty(C, dtype=torch.float32, device=x3.device)
    dbias = torch.empty_like(dscale)
    work = torch.empty(p.workspace, dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        err = lib.edl_group_norm_bwd(
            x3.data_ptr(), dy3.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            work.data_ptr(), B, HW, C, num_groups, p.rows, p.resident,
            p.pieces, p.vec, p.smem, int(bool(relu)), _DTYPES[x3.dtype],
            torch.cuda.current_stream(x3.device).cuda_stream)
    if err:
        raise RuntimeError(
            "group_norm backward kernel launch failed (cudaError_t %d) "
            "for B=%d HW=%d C=%d G=%d, %s" % (err, B, HW, C, num_groups, p))
    BWD_LAUNCHES += 1
    return dx, dscale, dbias


def group_norm_fwd(x3, scale, bias, num_groups, eps=1e-6, relu=False):
    """The kernel's contract (counterpart of ``_fwd_pallas``): x3
    [B, HW, C] -> (y, mean [B, 1, C] f32, rstd [B, 1, C] f32)."""
    if x3.device.type == "cpu":
        return _fwd_ref(x3, scale, bias, num_groups, eps, relu)
    if x3.device.type != "cuda":
        raise ValueError("group_norm runs on cuda or cpu, not %s"
                         % x3.device)
    return _fwd_cuda(x3, scale, bias, num_groups, eps, relu)


def group_norm_bwd(x3, dy3, scale, bias, mean, rstd, num_groups, eps=1e-6,
                   relu=False):
    """The backward kernel's contract (counterpart of ``_bwd_pallas``):
    x3, dy3 [B, HW, C], mean and rstd [B, 1, C] f32 from the forward
    -> (dx in x's dtype, dscale [C] f32, dbias [C] f32)."""
    if x3.device.type == "cpu":
        return _bwd_ref(x3, dy3, scale, bias, mean, rstd, num_groups, eps,
                        relu)
    if x3.device.type != "cuda":
        raise ValueError("group_norm runs on cuda or cpu, not %s"
                         % x3.device)
    return _bwd_cuda(x3, dy3, scale, bias, mean, rstd, num_groups, relu)


class _FusedGroupNorm(torch.autograd.Function):
    """GroupNorm + affine (+ ReLU) with the backward kernel as its
    pullback (counterpart of the JAX ``_fused`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, relu):
        B, C = x.shape[0], x.shape[-1]
        y3, mean, rstd = group_norm_fwd(x.reshape(B, -1, C), scale, bias,
                                        num_groups, eps, relu)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.config = (num_groups, eps, relu)
        return y3.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        global DY_COPIES
        x, scale, bias, mean, rstd = ctx.saved_tensors
        num_groups, eps, relu = ctx.config
        if not dy.is_contiguous():
            DY_COPIES += 1
            dy = dy.contiguous()
        B, C = x.shape[0], x.shape[-1]
        dx3, dscale, dbias = group_norm_bwd(
            x.reshape(B, -1, C), dy.view(B, -1, C), scale, bias, mean,
            rstd, num_groups, eps, relu)
        return (dx3.view(x.shape), dscale.to(scale.dtype),
                dbias.to(bias.dtype), None, None, None)


def fused_group_norm(x, scale, bias, num_groups, eps=1e-6, relu=False):
    """GroupNorm + affine (+ ReLU) over the trailing channel axis.

    x: [B, spatial..., C], channels-last in memory (contiguous); scale
    and bias: [C].  On the card a non-contiguous x raises instead of
    being copied.  With grad enabled the result is differentiable
    through the backward kernel."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(
            "channels %d not divisible by %d groups" % (C, num_groups)
        )
    if x.device.type != "cpu" and not x.is_contiguous():
        raise ValueError(
            "group_norm kernel takes channels-last memory; got shape %s "
            "strides %s (keep activations in torch.channels_last)"
            % (tuple(x.shape), x.stride()))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _FusedGroupNorm.apply(x, scale, bias, num_groups, eps, relu)
    return group_norm_op(x, scale, bias, num_groups, eps, relu)[0]


# -- the forward as one custom op ---------------------------------------------
#
# ``torch.export`` cannot trace through the ctypes launch (a fake tensor has
# no data pointer), so inference reaches the forward kernel through this op:
# an exported program holds one node per GroupNorm, and running the program
# on the card launches the kernel.  The CUDA implementation is the kernel,
# the CPU implementation the plain version; both are looked up at call time.
# It is declared through ``torch.library.Library``, not ``custom_op``,
# whose Python wrapper imports ``torch._dynamo`` at a process's first
# call.

_LIB = torch.library.Library("elasticdl_tpu_torch", "FRAGMENT")
_LIB.define("group_norm_fwd(Tensor x, Tensor scale, Tensor bias, "
            "int num_groups, float eps, bool relu) -> (Tensor, Tensor, "
            "Tensor)")


def _op_cpu(x, scale, bias, num_groups, eps, relu):
    B, C = x.shape[0], x.shape[-1]
    y3, mean, rstd = _fwd_ref(x.reshape(B, -1, C), scale, bias, num_groups,
                              eps, relu)
    return y3.reshape(x.shape).contiguous(), mean, rstd


def _op_cuda(x, scale, bias, num_groups, eps, relu):
    # The [B, HW, C] view is taken here, on the tensor the program
    # runs with, so a program holds no reshape (or copy) of x.
    if not x.is_contiguous():
        _check_x3(x)
    y3, mean, rstd = _fwd_cuda(x.view(x.shape[0], -1, x.shape[-1]), scale,
                               bias, num_groups, eps, relu)
    return y3.view(x.shape), mean, rstd


_LIB.impl("group_norm_fwd", _op_cpu, "CPU")
_LIB.impl("group_norm_fwd", _op_cuda, "CUDA")


@torch.library.register_fake("elasticdl_tpu_torch::group_norm_fwd", lib=_LIB)
def _(x, scale, bias, num_groups, eps, relu):
    stat = x.new_empty((x.shape[0], 1, x.shape[-1]), dtype=torch.float32)
    return x.new_empty(x.shape), stat, torch.empty_like(stat)


# ``group_norm_fwd`` as an operator: x [B, spatial..., C], contiguous on
# the card -> (y like x, mean [B, 1, C] f32, rstd [B, 1, C] f32); it
# carries no gradient.
group_norm_op = torch.ops.elasticdl_tpu_torch.group_norm_fwd.default
