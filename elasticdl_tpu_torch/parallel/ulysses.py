"""Ulysses-style all-to-all sequence parallelism (counterpart of
``elasticdl_tpu/parallel/ulysses.py``).

The second long-context strategy beside ring attention: an all-to-all
swaps the sequence sharding for a head sharding, every rank runs ordinary
flash attention (B3, and B4/B5 in the backward) over the whole sequence
for its heads, and a second all-to-all swaps back:

    [B, T/sp, H, D]  --a2a(seq<->heads)-->  [B, T, H/sp, D]
        -> attention_local (full causal context per head)
    [B, T, H/sp, D]  --a2a(heads<->seq)-->  [B, T/sp, H, D]

It needs H % sp == 0.  The all-to-all is ``transport.all_to_all``, its
own transpose, so autograd passes through to the flash Function's
backward.  As ``ring_attention``, it takes and returns this rank's shards.
"""

from elasticdl_tpu_torch.ops.flash_attention import _check_window
from elasticdl_tpu_torch.parallel import transport
from elasticdl_tpu_torch.parallel.ring_attention import attention_local


def _to_heads(x, group, n):
    """[B, T/n, H, D] -> [B, T, H/n, D]: gather the sequence, scatter the
    heads (the JAX tiled all_to_all, split_axis=2, concat_axis=1)."""
    b, t, h, d = x.shape
    chunks = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    out = transport.all_to_all(chunks, group)        # [n, B, T/n, H/n, D]
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _to_seq(x, group, n):
    """[B, T, H/n, D] -> [B, T/n, H, D], the inverse of ``_to_heads``."""
    b, t, h, d = x.shape
    chunks = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
    out = transport.all_to_all(chunks, group)        # [n, B, T/n, H/n, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)


def ulysses_attention(q, k, v, mesh, causal=True, scale=None, window=0):
    """All-to-all sequence-parallel attention over ``mesh``'s ``sp`` axis.

    q, k, v: this rank's shards [B/dp, T/sp, H, D] -> this rank's output
    shard.  Requires H % sp == 0.  Without a mesh, or with ``sp`` 1, it is
    ``attention_local`` (with the window).
    """
    _check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mesh is None or mesh.shape["sp"] == 1:
        return attention_local(q, k, v, causal=causal, scale=scale,
                               window=window)
    n = mesh.shape["sp"]
    if q.shape[2] % n:
        raise ValueError(
            "ulysses needs heads %% sp == 0, got %d heads over sp=%d"
            % (q.shape[2], n))
    group = mesh.group("sp")
    q, k, v = (_to_heads(t, group, n) for t in (q, k, v))
    out = attention_local(q, k, v, causal=causal, scale=scale, window=window)
    return _to_seq(out, group, n)
