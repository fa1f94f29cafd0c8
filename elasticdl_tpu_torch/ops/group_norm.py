"""GroupNorm + affine (+ ReLU) forward: the CUDA kernel and its wrapper.

Counterpart of ``elasticdl_tpu/ops/group_norm.py``.  The kernel
(``csrc/group_norm.cu``) replaces the TPU kernel ``_fwd_kernel``
(launched by ``_fwd_pallas``) and is bound by device-memory bytes: its
header says how the design splits the work across the card.

Layout: channels-last ``[..., C]``; statistics per group over
(spatial..., C/G), as flax.linen.GroupNorm computes them, with the
variance centered.  ``eps`` defaults to flax's 1e-6, not torch's 1e-5.

Dispatch is by the tensor's device alone: a CPU tensor goes through the
plain PyTorch version (``_group_norm_ref``); a CUDA tensor launches the
kernel or raises.  There is no switch to the plain version on the card.
``LAUNCHES`` counts kernel launches.
"""

import ctypes
import functools

import torch

from elasticdl_tpu_torch.ops import build

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Elements of x per statistics block: enough blocks to fill the card at
# serving batch sizes, enough rows per block to amortize its merge.
_ELEMS_PER_CHUNK = 8192


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


def _chunk_rows(HW, C):
    return max(1, min(HW, _ELEMS_PER_CHUNK // C))


@functools.cache
def _library():
    lib = build.library("group_norm")
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.edl_group_norm_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        cint, cint, cint, cint, cint, ctypes.c_float, cint, cint, ptr]
    lib.edl_group_norm_fwd.restype = cint
    lib.edl_group_norm_fwd_workspace.argtypes = [cint] * 4
    lib.edl_group_norm_fwd_workspace.restype = ctypes.c_int64
    return lib


def _fwd_cuda(x3, scale, bias, num_groups, eps, relu):
    global LAUNCHES
    if x3.dtype not in _DTYPES:
        raise TypeError("group_norm kernel takes float32 or bfloat16, "
                        "got %s" % x3.dtype)
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(
            "group_norm kernel takes a contiguous channels-last "
            "[B, HW, C] tensor (keep activations in torch.channels_last); "
            "got shape %s strides %s" % (tuple(x3.shape), x3.stride()))
    B, HW, C = x3.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (C,) or t.device != x3.device:
            raise ValueError("%s must be [%d] on %s, got %s on %s" % (
                name, C, x3.device, tuple(t.shape), t.device))
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    rows = _chunk_rows(HW, C)
    lib = _library()
    y = torch.empty_like(x3)
    mean = torch.empty((B, 1, C), dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    work = torch.empty(
        lib.edl_group_norm_fwd_workspace(B, HW, C, rows),
        dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        err = lib.edl_group_norm_fwd(
            x3.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            work.data_ptr(), B, HW, C, num_groups, rows, float(eps),
            int(bool(relu)), _DTYPES[x3.dtype],
            torch.cuda.current_stream(x3.device).cuda_stream)
    if err:
        raise RuntimeError(
            "group_norm kernel launch failed (cudaError_t %d) for "
            "B=%d HW=%d C=%d G=%d" % (err, B, HW, C, num_groups))
    LAUNCHES += 1
    return y, mean, rstd


def group_norm_fwd(x3, scale, bias, num_groups, eps=1e-6, relu=False):
    """The kernel's contract (counterpart of ``_fwd_pallas``): x3
    [B, HW, C] -> (y, mean [B, 1, C] f32, rstd [B, 1, C] f32)."""
    if x3.device.type == "cpu":
        return _fwd_ref(x3, scale, bias, num_groups, eps, relu)
    if x3.device.type != "cuda":
        raise ValueError("group_norm runs on cuda or cpu, not %s"
                         % x3.device)
    return _fwd_cuda(x3, scale, bias, num_groups, eps, relu)


def fused_group_norm(x, scale, bias, num_groups, eps=1e-6, relu=False):
    """GroupNorm + affine (+ ReLU) over the trailing channel axis.

    x: [B, spatial..., C], channels-last in memory (contiguous); scale
    and bias: [C].  On the card a non-contiguous x raises instead of
    being copied."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(
            "channels %d not divisible by %d groups" % (C, num_groups)
        )
    if x.device.type == "cpu":
        return _group_norm_ref(x, scale, bias, num_groups, eps, relu)
    if not x.is_contiguous():
        raise ValueError(
            "group_norm kernel takes channels-last memory; got shape %s "
            "strides %s (keep activations in torch.channels_last)"
            % (tuple(x.shape), x.stride()))
    y3 = group_norm_fwd(x.view(x.shape[0], -1, C), scale, bias,
                        num_groups, eps, relu)[0]
    return y3.view(x.shape)
