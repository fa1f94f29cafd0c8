"""Flash attention forward: the CUDA kernel, its wrapper and its plain
PyTorch versions.

Counterpart of ``elasticdl_tpu/ops/flash_attention.py``.  The kernel,
``csrc/flash_attention.cu``, replaces the TPU kernel ``_flash_kernel``
(launched by ``_flash_forward``); its header says what bounds it and how
it splits the work across the card.

Layout: [batch, heads, seq, head_dim], as in the JAX package.  The
kernel takes any strides with a contiguous last dim and writes its
output with q's strides, so the ring layout [B, T, H, D] goes in and
comes out as a transposed view, without a copy
(``parallel/ring_attention.py``).

Dispatch is by the tensor's device alone: a CPU tensor goes through the
plain version (``_flash_ref``); a CUDA tensor launches the kernel or
raises.  There is no switch to the plain version on the card, and the
JAX wrapper's route of unfriendly shapes to jnp has no counterpart: a
head_dim the kernel does not take raises.  ``LAUNCHES`` counts kernel
launches.

The backward kernels (the TPU's ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``) are not ported yet: on the card, with grad enabled
and an input that requires a gradient, the forward raises instead of
returning an output that carries none.
"""

import ctypes
import functools

import torch

from elasticdl_tpu_torch.ops import build

NEG_INF = -1e30
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_window(window, causal):
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if window < 0:
        raise ValueError("window must be >= 0, got %d" % window)


def _mask(tq, tk, causal, window, device):
    """[tq, tk] bool of the kept (query, key) pairs, or None."""
    if not causal:
        return None
    diff = (torch.arange(tq, device=device)[:, None]
            - torch.arange(tk, device=device)[None, :])
    keep = diff >= 0
    if window:
        keep &= diff < window
    return keep


def _scores(q, k, causal, scale, window):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = _mask(q.shape[-2], k.shape[-2], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _attention_ref(q, k, v, causal, scale, window=0):
    """The JAX ``_attention_ref``: dense softmax attention in f32,
    output in q's dtype."""
    p = torch.softmax(_scores(q, k, causal, scale, window), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _flash_ref(q, k, v, causal, scale, window=0):
    """Plain version of the kernel, with its final arithmetic: s in f32,
    scaled and masked with NEG_INF; m the row max; p = exp(s - m) and
    l = sum(p) in f32; acc = p cast to v's dtype (the TPU kernel's
    rounding of p) times v, accumulated in f32; out = acc / max(l,
    1e-30) in q's dtype.  Returns (out, l [B, H, T] f32, m [B, H, T]
    f32)."""
    s = _scores(q, k, causal, scale, window)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, l, m


def _bind(lib):
    """Declare ``edl_flash_attention_fwd``'s C signature on a loaded
    library (also used by scripts/sweep_flash_attention.py)."""
    ptr, cint, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.edl_flash_attention_fwd.argtypes = (
        [ptr] * 6 + [cint] * 4 + [i64] * 12
        + [ctypes.c_float, cint, cint, cint, ptr])
    lib.edl_flash_attention_fwd.restype = cint
    return lib


@functools.cache
def _library():
    return _bind(build.library("flash_attention"))


def _check_cuda_inputs(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention's backward kernels (dq, dk/dv) are not "
            "ported yet, so the kernel's output carries no gradient; run "
            "under torch.no_grad() or torch.inference_mode()")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash attention kernel takes q, k, v all float32 or all "
            "bfloat16, got %s, %s, %s" % (q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash attention kernel takes q, k, v of one shape [B, H, T, "
            "D], got %s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            "flash attention kernel takes head_dim 64 or 128, got shape "
            "%s" % (tuple(q.shape),))
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v on %s, %s, %s" % (q.device, k.device,
                                                    v.device))
    # 16-byte rows: the kernel loads each row in 16-byte vectors.
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s % vec for s in t.stride()[:-1])):
            raise ValueError(
                "flash attention kernel takes %s with a contiguous last "
                "dim and 16-byte aligned rows; got strides %s"
                % (name, t.stride()))


def _launch(q, k, v, o, causal, scale, window):
    """Run the kernel on [B, H, T, D] views q, k, v, o; returns (l, m)."""
    global LAUNCHES
    B, H, T, D = q.shape
    l = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _library().edl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), B, H, T, D, *strides,
            float(scale), int(bool(causal)), int(window),
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            "flash attention kernel launch failed (cudaError_t %d) for "
            "B=%d H=%d T=%d D=%d %s" % (err, B, H, T, D, q.dtype))
    LAUNCHES += 1
    return l, m


def _check_device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("flash attention runs on cuda or cpu, not %s"
                         % q.device)


def flash_forward(q, k, v, causal=True, scale=None, window=0):
    """The kernel's contract (counterpart of ``_flash_forward``): q, k, v
    [B, H, T, D] -> (out [B, H, T, D] in q's dtype, l [B, H, T] f32,
    m [B, H, T] f32).  ``window`` > 0 keeps only the last ``window``
    positions of causal attention."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    if q.device.type == "cpu":
        return _flash_ref(q, k, v, causal, scale, window)
    _check_cuda_inputs(q, k, v)
    # Strides as q's (preserve_format): a transposed [B, T, H, D] view in
    # gives one out, so the caller's transpose back is contiguous.
    out = torch.empty_like(q)
    l, m = _launch(q, k, v, out, causal, scale, window)
    return out, l, m


def flash_attention(q, k, v, causal=True, scale=None, window=0):
    """q, k, v: [batch, heads, seq, head_dim] -> attention output in the
    same layout and q's dtype."""
    return flash_forward(q, k, v, causal=causal, scale=scale,
                         window=window)[0]

