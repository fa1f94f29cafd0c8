"""Flash attention, forward and backward: the CUDA kernels, their
wrappers and their plain PyTorch versions.

Counterpart of ``elasticdl_tpu/ops/flash_attention.py``.  The forward
kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel
``_flash_kernel`` (launched by ``_flash_forward``); the backward kernels,
``csrc/flash_attention_bwd.cu``, replace ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (launched by ``_pallas_bwd``).  Each source's header
says what bounds it and how it splits the work across the card; in both,
bfloat16 at head_dim 64 (the flagship LM's attention) runs on wgmma fed
by TMA, head_dim 128 and float32 on earlier designs, chosen by dtype and
head_dim in the C entry points.

Layout: [batch, heads, seq, head_dim], as in the JAX package.  The
kernels take any strides with a contiguous last dim and write their
outputs with their inputs' strides, so the ring layout [B, T, H, D] goes
in and comes out as a transposed view, without a copy
(``parallel/ring_attention.py``).

``flash_attention_partial`` is the same forward kernel without the final
normalisation (B3p, the TPU kernel launched with ``normalize=False``):
it returns one KV block's f32 (acc, l, m), the state ring attention folds
(``parallel/ring_attention.py``).  Its backward is the JAX package's jnp
pullback ``_partial_stats_bwd`` in plain PyTorch on both devices (the JAX
package has no kernel for it either).

``flash_attention`` is one ``torch.autograd.Function`` on both devices
(the JAX ``custom_vjp`` ``_flash``): its forward is ``flash_forward``, it
saves the residuals (q, k, v, out, l, m) and its backward is
``flash_backward``.  Dispatch is by the tensor's device alone: a CPU
tensor goes through the plain versions (``_flash_ref``,
``_flash_bwd_ref``); a CUDA tensor launches the kernels or raises.  The
JAX wrapper's route of unfriendly shapes to jnp has no counterpart: a
head_dim the kernels do not take raises.  ``flash_attention_ref`` runs
the same Function on the plain versions whatever the device, so a check
on the card can compare with them; no model path calls it.  Where no
input requires a gradient, ``flash_attention`` calls the forward as the
custom op ``flash_attention_op`` (``elasticdl_tpu_torch::
flash_attention_fwd``) instead, which ``torch.export`` captures in a
servable program (``serving/export.py``).
``LAUNCHES``, ``PARTIAL_LAUNCHES``, ``BWD_DQ_LAUNCHES`` and
``BWD_DKV_LAUNCHES`` count kernel launches.
"""

import ctypes
import functools

import torch

from elasticdl_tpu_torch.ops import build

NEG_INF = -1e30
LAUNCHES = 0            # forward (B3)
PARTIAL_LAUNCHES = 0    # unnormalised forward (B3p)
BWD_DQ_LAUNCHES = 0     # backward dq (B4)
BWD_DKV_LAUNCHES = 0    # backward dk, dv (B5)

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


def _flash_bwd_ref(q, k, v, out, l, m, g, causal, scale, window=0):
    """Plain version of the backward kernels, with the arithmetic of the
    TPU pair ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``: p = exp(s - m) /
    max(l, 1e-30) rebuilt from the saved stats; dp = dO v^T and delta =
    rowsum(dO O) in f32; ds = p (dp - delta) scale rounded to q's dtype
    before both the ds k and the ds^T q products; p rounded to dO's dtype
    before p^T dO.  g (dO) is cast to q's dtype first, as ``_pallas_bwd``
    does.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    g = g.to(q.dtype)
    gf = g.float()
    p = torch.exp(_scores(q, k, causal, scale, window) - m[..., None])
    p = p / torch.clamp(l, min=1e-30)[..., None]
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = (p * (ds - delta) * scale).to(q.dtype).float()
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), gf)
    del p
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind(lib):
    """Declare the C signatures of ``edl_flash_attention_fwd`` (B3) and
    ``edl_flash_attention_partial_fwd`` (B3p) on a loaded library (also
    used by scripts/sweep_flash_attention.py)."""
    ptr, cint, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.edl_flash_attention_fwd,
               lib.edl_flash_attention_partial_fwd):
        fn.argtypes = ([ptr] * 6 + [cint] * 4 + [i64] * 12
                       + [ctypes.c_float, cint, cint, cint, ptr])
        fn.restype = cint
    return lib


@functools.cache
def _library():
    return _bind(build.library("flash_attention"))


def _bind_bwd(lib):
    """Declare the C signatures of ``edl_flash_attention_bwd_dq`` and
    ``_dkv`` on a loaded library (also used by
    scripts/sweep_flash_attention.py)."""
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.edl_flash_attention_bwd_dq,
               lib.edl_flash_attention_bwd_dkv):
        fn.argtypes = ([ptr] * 12 + [cint] * 4
                       + [ctypes.c_float, cint, cint, cint, ptr])
        fn.restype = cint
    return lib


@functools.cache
def _bwd_library():
    return _bind_bwd(build.library("flash_attention_bwd"))


def _rows_ok(t):
    """Whether the kernels can read ``t`` as it is: a contiguous last dim
    and 16-byte aligned rows (they load each row in 16-byte vectors)."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % vec for s in t.stride()[:-1]))


def _check_cuda_inputs(q, k, v):
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_ok(t):
            raise ValueError(
                "flash attention kernel takes %s with a contiguous last "
                "dim and 16-byte aligned rows; got strides %s"
                % (name, t.stride()))


def _launch(q, k, v, o, causal, scale, window, normalize=True):
    """Run the kernel on [B, H, T, D] views q, k, v, o; returns (l, m).
    ``normalize=False`` runs B3p: o is float32 and receives acc."""
    global LAUNCHES, PARTIAL_LAUNCHES
    B, H, T, D = q.shape
    l = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _library()
    fn = (lib.edl_flash_attention_fwd if normalize
          else lib.edl_flash_attention_partial_fwd)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 l.data_ptr(), m.data_ptr(), B, H, T, D, *strides,
                 float(scale), int(bool(causal)), int(window),
                 _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            "flash attention %s kernel launch failed (cudaError_t %d) for "
            "B=%d H=%d T=%d D=%d %s" % (
                "forward" if normalize else "partial", err, B, H, T, D,
                q.dtype))
    if normalize:
        LAUNCHES += 1
    else:
        PARTIAL_LAUNCHES += 1
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


def _launch_bwd(which, q, k, v, out, l, m, g, dq, dk, dv, delta, causal,
                scale, window):
    """Run backward kernel ``which`` ("dq" or "dkv") on [B, H, T, D] views
    on the current stream; the slots it does not write may hold any
    tensor of q's shape and dtype."""
    B, H, T, D = q.shape
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, out, g, dq, dk, dv) for s in t.stride()[:3]])
    fn = getattr(_bwd_library(), "edl_flash_attention_bwd_" + which)
    with torch.cuda.device(q.device):
        err = fn(*[t.data_ptr() for t in (q, k, v, out, g, dq, dk, dv, l, m,
                                         delta)],
                 ctypes.addressof(strides), B, H, T, D, float(scale),
                 int(bool(causal)),
                 int(window), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            "flash attention backward kernel (%s) launch failed "
            "(cudaError_t %d) for B=%d H=%d T=%d D=%d %s"
            % (which, err, B, H, T, D, q.dtype))


def _bwd_scratch(q):
    """The f32 scratch that B4 writes and B5 reads, four floats per row of
    q [B, H, T, D]: the bf16 D=64 pair keeps (m log2 e, 1 / max(l,
    1e-30), delta = rowsum(dO O), delta scale) per row there; the other
    kernels keep delta alone in its first B*H*T floats."""
    return torch.empty(q.shape[:3] + (4,), dtype=torch.float32,
                       device=q.device)


def _launch_dq(q, k, v, out, l, m, g, dq, delta, causal, scale, window):
    """B4: writes dq and, into the scratch ``delta`` (``_bwd_scratch``),
    the row stats that B5 reads."""
    global BWD_DQ_LAUNCHES
    _launch_bwd("dq", q, k, v, out, l, m, g, dq, dq, dq, delta, causal,
                scale, window)
    BWD_DQ_LAUNCHES += 1


def _launch_dkv(q, k, v, out, l, m, g, dk, dv, delta, causal, scale,
                window):
    """B5: writes dk and dv; reads the row stats that B4 wrote."""
    global BWD_DKV_LAUNCHES
    _launch_bwd("dkv", q, k, v, out, l, m, g, dk, dk, dv, delta, causal,
                scale, window)
    BWD_DKV_LAUNCHES += 1


def _check_residuals(q, out, l, m, g):
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(
            "flash attention backward takes out and g of q's shape and out "
            "of q's dtype, got %s %s, %s" % (tuple(out.shape), out.dtype,
                                             tuple(g.shape)))
    for name, t in (("l", l), ("m", m)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:3]
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                "flash attention backward takes %s contiguous float32 "
                "[B, H, T] on q's device, got %s %s" % (
                    name, t.dtype, tuple(t.shape)))
    if not _rows_ok(out):
        raise ValueError(
            "flash attention backward takes out with a contiguous last dim "
            "and 16-byte aligned rows; got strides %s" % (out.stride(),))


def flash_backward(q, k, v, out, l, m, g, causal=True, scale=None,
                   window=0):
    """The backward kernels' contract (counterpart of ``_pallas_bwd``):
    the residuals (q, k, v, out, l, m) of ``flash_forward`` and the
    gradient g of out -> (dq, dk, dv) in q's, k's and v's dtypes and
    strides."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    if q.device.type == "cpu":
        return _flash_bwd_ref(q, k, v, out, l, m, g, causal, scale, window)
    _check_cuda_inputs(q, k, v)
    _check_residuals(q, out, l, m, g)
    g = g.to(q.dtype)
    if not _rows_ok(g):
        # e.g. the stride-0 expansion that ``.sum()``'s backward hands in
        g = g.contiguous()
    # The outputs keep their inputs' strides (preserve_format), so the
    # ring layout's transposes back are views.
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = _bwd_scratch(q)
    _launch_dq(q, k, v, out, l, m, g, dq, delta, causal, scale, window)
    _launch_dkv(q, k, v, out, l, m, g, dk, dv, delta, causal, scale, window)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention with its backward (the JAX ``custom_vjp``
    ``_flash``): saves exactly the residuals (q, k, v, out, l, m).
    ``plain`` runs the plain versions whatever the device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, plain):
        if plain:
            out, l, m = _flash_ref(q, k, v, causal, scale, window)
        else:
            out, l, m = flash_forward(q, k, v, causal=causal, scale=scale,
                                      window=window)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.args = (causal, scale, window, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, l, m = ctx.saved_tensors
        causal, scale, window, plain = ctx.args
        if plain:
            grads = _flash_bwd_ref(q, k, v, out, l, m, g, causal, scale,
                                   window)
        else:
            grads = flash_backward(q, k, v, out, l, m, g, causal=causal,
                                   scale=scale, window=window)
        return grads + (None,) * 4


def _apply(q, k, v, causal, scale, window, plain):
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    return _Flash.apply(q, k, v, causal, scale, window, plain)


def flash_attention(q, k, v, causal=True, scale=None, window=0):
    """q, k, v: [batch, heads, seq, head_dim] -> attention output in the
    same layout and q's dtype, differentiable: the kernels on the card,
    the plain versions on the CPU.  Where no input requires a gradient
    (inference), the forward runs as the custom op ``flash_attention_op``
    and saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _apply(q, k, v, causal, scale, window, plain=False)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    return flash_attention_op(q, k, v, causal, scale, window)[0]


# The forward as one custom op: ``torch.export`` cannot trace through the
# ctypes launch (a fake tensor has no data pointer), so inference reaches
# the kernel through this op, and an exported program holds one node per
# attention call.  The CUDA implementation is ``flash_forward`` (the
# kernel), the CPU implementation the plain version.  Declared through
# ``torch.library.Library``, as ``ops/group_norm.py``'s op.

_LIB = torch.library.Library("elasticdl_tpu_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, int window) -> (Tensor, Tensor, Tensor)")


def _op_cpu(q, k, v, causal, scale, window):
    return _flash_ref(q, k, v, causal, scale, window)


def _op_cuda(q, k, v, causal, scale, window):
    return flash_forward(q, k, v, causal=causal, scale=scale, window=window)


_LIB.impl("flash_attention_fwd", _op_cpu, "CPU")
_LIB.impl("flash_attention_fwd", _op_cuda, "CUDA")


@torch.library.register_fake("elasticdl_tpu_torch::flash_attention_fwd",
                             lib=_LIB)
def _(q, k, v, causal, scale, window):
    # The kernel writes out with q's strides; the plain version's out is
    # contiguous.
    out = (torch.empty_like(q) if q.device.type == "cuda"
           else q.new_empty(q.shape))
    stat = q.new_empty(q.shape[:3], dtype=torch.float32)
    return out, stat, torch.empty_like(stat)


# ``flash_forward`` as an operator: (out, l, m); it carries no gradient.
flash_attention_op = torch.ops.elasticdl_tpu_torch.flash_attention_fwd.default


def flash_attention_ref(q, k, v, causal=True, scale=None, window=0):
    """``flash_attention`` through the plain versions on any device: the
    card's checks compare the kernels with it.  No model path calls it."""
    return _apply(q, k, v, causal, scale, window, plain=True)


# -- the unnormalised partial (B3p) and its pullback --------------------------

PARTIAL_BLOCK_K = 128   # the JAX ``flash_attention_partial``'s block_k


def _kv_blocks(k, v, block_k):
    """Split [B, H, Tk, D] K/V into ``Tk / block_k`` f32 blocks [B, H,
    block_k, D] (the JAX ``_kv_blocks``, as lists)."""
    kb = k.float().split(block_k, dim=2)
    vb = v.float().split(block_k, dim=2)
    return len(kb), [b.contiguous() for b in kb], [b.contiguous() for b in vb]


def _masked_block_scores(qf, kf, ki, block_k, causal, scale, k_offset, q_pos,
                         window=0):
    """One [B, H, T, block_k] f32 score tile, causally masked against k rows
    offset by ``k_offset + ki * block_k``: (scores, mask), mask None when not
    causal.  Both blockwise passes of ``_partial_stats_bwd`` recompute their
    scores here, so they compare equal bits."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if not causal:
        return s, None
    k_pos = k_offset + ki * block_k + torch.arange(kf.shape[2],
                                                   device=qf.device)
    diff = q_pos[:, None] - k_pos[None, :]
    mask = diff >= 0
    if window:
        mask &= diff < window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _partial_ref(q, k, v, causal, scale, k_offset, window=0):
    """The JAX ``_partial_ref``: unnormalised block attention in f32, the
    plain version of B3p and the route of a causal block with a k offset.
    q rows are at local positions, k rows at ``k_offset`` + local ones;
    ``window`` > 0 keeps q_pos - k_pos in [0, window).  Returns (acc
    [B, H, T, D], l [B, H, T], m [B, H, T]), all f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        diff = (torch.arange(tq, device=q.device)[:, None]
                - (k_offset + torch.arange(tk, device=q.device))[None, :])
        mask = diff >= 0
        if window:
            mask &= diff < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.matmul(p, v.float()), p.sum(dim=-1), m


def _fold(o, l, m, acc_i, l_i, m_i):
    """Fold one block's (acc, l, m) into the running f32 (o, l, m)."""
    m_new = torch.maximum(m, m_i)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_i - m_new)
    return (o * alpha[..., None] + acc_i * beta[..., None],
            l * alpha + l_i * beta, m_new)


def _empty_state(q):
    """The fold's initial (o, l, m) for q [B, H, T, D]: (0, 0, NEG_INF)."""
    shape = q.shape[:3]
    return (q.new_zeros(q.shape, dtype=torch.float32),
            q.new_zeros(shape, dtype=torch.float32),
            q.new_full(shape, NEG_INF, dtype=torch.float32))


def _banded_block(qf, kb, vb, ki, block_k, scale, k_offset, q_pos, window):
    s, _ = _masked_block_scores(qf, kb, ki, block_k, True, scale, k_offset,
                                q_pos, window=window)
    m_i = s.amax(dim=-1)
    p = torch.exp(s - m_i[..., None])
    return torch.matmul(p, vb), p.sum(dim=-1), m_i


def _partial_banded(q, k, v, scale, k_offset, window, block_k=PARTIAL_BLOCK_K):
    """The JAX ``_partial_banded``: a causal banded partial for the ring's
    window-straddling block, whose offset depends on the rank.  Walks K in
    blocks with the online-softmax fold, each block's math under
    ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), so live memory
    is O(T x block_k) in both directions.  ``_partial_ref`` when Tk does
    not split into two or more blocks."""
    tk = k.shape[2]
    if tk % block_k or tk // block_k <= 1:
        return _partial_ref(q, k, v, True, scale, k_offset, window=window)
    qf = q.float()
    q_pos = torch.arange(q.shape[2], device=q.device)
    num_k, k_blocks, v_blocks = _kv_blocks(k, v, block_k)
    state = _empty_state(q)
    for ki in range(num_k):
        state = _fold(*state, *torch.utils.checkpoint.checkpoint(
            _banded_block, qf, k_blocks[ki], v_blocks[ki], ki, block_k,
            scale, k_offset, q_pos, window, use_reentrant=False))
    return state


def _partial_stats_bwd(q, k, v, acc, l, ga, gl, gm, causal, scale, k_offset,
                       block_k, window=0):
    """The JAX ``_partial_stats_bwd``: the pullback of (acc, l, m) =
    partial(q, k, v) walking K in blocks, each [T, block_k] score tile
    recomputed; live memory O(T x block_k) plus the gradient accumulators.

    With e_ij = exp(s_ij - m_i), the pullback of (ga, gl, gm) is
        ds_ij = e_ij (ga_i . v_j + gl_i) + (ind_ij / cnt_i) c_i,
        c_i   = gm_i - ga_i . acc_i - gl_i l_i,
        dv_j  = sum_i e_ij ga_i,  dq = scale ds k,  dk = scale ds^T q,
    where ind marks the row-max positions and cnt splits ties as the
    gradient of a row max does.  m is recomputed (pass 1) from the scores
    pass 3 uses, not taken from the kernel, so the ``s == m`` indicator
    compares equal bits; the saved acc and l feed c only."""
    qf = q.float()
    q_pos = torch.arange(q.shape[2], device=q.device)
    num_k, k_blocks, v_blocks = _kv_blocks(k, v, block_k)
    gaf = ga.float()

    def scores(ki):
        return _masked_block_scores(qf, k_blocks[ki], ki, block_k, causal,
                                    scale, k_offset, q_pos, window=window)

    # Pass 1: the row max, recomputed so that pass 3's indicator is exact.
    m_re = q.new_full(q.shape[:3], NEG_INF, dtype=torch.float32)
    for ki in range(num_k):
        m_re = torch.maximum(m_re, scores(ki)[0].amax(dim=-1))
    # Pass 2: the ties at the max.
    cnt = torch.zeros(q.shape[:3], dtype=torch.int64, device=q.device)
    for ki in range(num_k):
        cnt += (scores(ki)[0] == m_re[..., None]).sum(dim=-1)
    c = ((gm.float() - (gaf * acc.float()).sum(dim=-1)
          - gl.float() * l.float()) / cnt.clamp(min=1).float())
    # Pass 3: the gradients, one K block at a time.
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ki in range(num_k):
        s, mask = scores(ki)
        e = torch.exp(s - m_re[..., None])
        ds = e * (torch.matmul(gaf, v_blocks[ki].transpose(-1, -2))
                  + gl.float()[..., None])
        ds = ds + torch.where(s == m_re[..., None], c[..., None],
                              torch.zeros_like(s))
        if mask is not None:
            # the dense gradient is 0 where the forward masked
            ds = torch.where(mask, ds, torch.zeros_like(ds))
        dvs.append(torch.matmul(e.transpose(-1, -2), gaf))
        dks.append(torch.matmul(ds.transpose(-1, -2), qf) * scale)
        dq = dq + torch.matmul(ds, k_blocks[ki]) * scale
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def flash_partial_forward(q, k, v, causal=True, scale=None, window=0):
    """B3p's contract (the JAX ``_flash_forward(normalize=False)``): q, k,
    v [B, H, T, D] -> (acc [B, H, T, D], l [B, H, T], m [B, H, T]), all
    f32, for keys at the same positions as the queries.  The kernel on a
    CUDA tensor, ``_partial_ref`` on a CPU one."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    if q.device.type == "cpu":
        return _partial_ref(q, k, v, causal, scale, 0, window)
    _check_cuda_inputs(q, k, v)
    acc = torch.empty_like(q, dtype=torch.float32)
    l, m = _launch(q, k, v, acc, causal, scale, window, normalize=False)
    return acc, l, m


class _FlashPartial(torch.autograd.Function):
    """The JAX ``custom_vjp`` ``_flash_partial``: B3p forward, saving
    (q, k, v, acc, l) as ``_flash_partial_fwd`` does; the backward is
    ``_partial_stats_bwd`` when K splits into two or more blocks, else
    autograd through ``_partial_ref``, as ``_flash_partial_bwd`` routes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        acc, l, m = flash_partial_forward(q, k, v, causal=causal,
                                          scale=scale, window=window)
        ctx.save_for_backward(q, k, v, acc, l)
        ctx.args = (causal, scale, window)
        return acc, l, m

    @staticmethod
    def backward(ctx, ga, gl, gm):
        q, k, v, acc, l = ctx.saved_tensors
        causal, scale, window = ctx.args
        tk, block_k = k.shape[2], min(PARTIAL_BLOCK_K, q.shape[2])
        if tk % block_k == 0 and tk // block_k > 1:
            grads = _partial_stats_bwd(q, k, v, acc, l, ga, gl, gm, causal,
                                       scale, 0, block_k, window=window)
        else:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                outs = _partial_ref(*leaves, causal, scale, 0, window)
                grads = torch.autograd.grad(outs, leaves, (ga, gl, gm))
        return grads + (None,) * 3


def flash_attention_partial(q, k, v, causal=True, scale=None, k_offset=0,
                            window=0):
    """Unnormalised online-softmax attention of q against one KV block:
    (acc [B, H, T, D], l [B, H, T], m [B, H, T]), all f32, ready to fold
    into a running (o, l, m), differentiable; ring attention's per-block
    step.  Causal masking compares local q rows against k rows shifted by
    ``k_offset``.  B3p serves every block without an offset (the ring's
    diagonal, and every non-causal block) on the card, its plain version
    on the CPU; a causal block with an offset, whose mask the kernel does
    not take, goes to ``_partial_ref`` as in the JAX package."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_window(window, causal)
    _check_device(q)
    if causal and k_offset != 0:
        return _partial_ref(q, k, v, causal, scale, k_offset, window=window)
    return _FlashPartial.apply(q, k, v, causal, scale, window)
