"""Single-device attention in the ring layout (counterpart of
``attention_local`` and of ``ring_attention`` with ``mesh=None`` in
``elasticdl_tpu/parallel/ring_attention.py``).

The sequence-parallel ring over a mesh axis, its unnormalised partial
kernel (``flash_attention_partial``) and the other mesh paths are not
ported yet: a mesh raises.
"""

from elasticdl_tpu_torch.ops.flash_attention import (
    _check_window,
    flash_attention,
)


def attention_local(q, k, v, causal=True, scale=None, window=0):
    """q, k, v: [batch, seq, heads, head_dim] -> the same layout, through
    the flash attention kernels on the card (their plain versions on the
    CPU), differentiable: the transposed views go into the Function and
    its gradients come back with the inputs' strides.  ``window`` > 0 =
    sliding-window causal attention."""
    _check_window(window, causal)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, scale=scale,
                        window=window)
    return o.transpose(1, 2)


def ring_attention(q, k, v, mesh, causal=True, scale=None, window=0):
    """Sequence-parallel attention; only ``mesh=None`` (one device) is
    ported, which is ``attention_local``."""
    _check_window(window, causal)
    if mesh is not None:
        raise NotImplementedError(
            "ring attention over a mesh is not ported yet (ROADMAP A17: "
            "the ring and flash_attention_partial; A18: meshes)")
    return attention_local(q, k, v, causal=causal, scale=scale,
                           window=window)
