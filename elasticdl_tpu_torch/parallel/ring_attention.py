"""Ring attention: sequence parallelism over a mesh's ``sp`` axis
(counterpart of ``elasticdl_tpu/parallel/ring_attention.py``).

The sequence is sharded over ``sp``: each rank holds a block of queries
and passes key/value blocks around the ring, folding every block into an
online softmax in f32.  The block step is ``flash_attention_partial``
(B3p on the card).  Causal folds dispatch per ring step: the diagonal
block runs the causal kernel, blocks from lower ranks the non-causal
kernel, and blocks from higher ranks are skipped, about half the ring's
FLOPs; with a sliding window, blocks past the band are skipped too,
blocks inside it run non-causal, and a block the band's edge crosses runs
``_partial_banded`` with a rank-dependent offset.

The JAX function takes global arrays and runs the fold per device under
``shard_map``.  Here each rank is a process, and ``ring_attention`` takes
and returns this rank's shards [B/dp, T/sp, H, D]; the K/V rotation is
``transport.ring_shift``, whose gradient is the shift back (the transpose
of ``ppermute``), so autograd through the blocks, the fold and the shifts
gives the gradients ``jax.grad`` gives through ``shard_map``.  Every rank
shifts at every ring step but the last (whose result the JAX loop drops),
skipped blocks included: the ranks stay in step, and a layer's remat
recompute repeats the same shifts on every rank.

Layout convention: [batch, seq, heads, head_dim], as in the JAX package.
"""

import torch

from elasticdl_tpu_torch.ops.flash_attention import (
    _check_window,
    _empty_state,
    _fold,
    _partial_banded,
    flash_attention,
    flash_attention_partial,
)
from elasticdl_tpu_torch.parallel import transport


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


class _Skip(torch.autograd.Function):
    """A skipped block's (acc, l, m) = (0, 0, NEG_INF), tied to the block's
    k and v with a zero gradient, so that the shift which brought them in
    runs its backward on this rank as on the ranks that used them."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return _empty_state(q)

    @staticmethod
    def backward(ctx, ga, gl, gm):
        return (None,) + tuple(torch.zeros(shape, dtype=dtype, device=device)
                               for shape, dtype, device in ctx.like)


def _block(q, k, v, rank, src, n_local, causal, scale, window):
    """One ring step's partial (acc, l, m) for the KV block of rank
    ``src``: the JAX dispatch of ``_ring_attention_local``."""
    if not causal:
        return flash_attention_partial(q, k, v, causal=False, scale=scale)
    if src == rank:
        return flash_attention_partial(q, k, v, causal=True, scale=scale,
                                       window=window)
    delta = rank - src
    if src > rank or (window and delta * n_local - (n_local - 1) >= window):
        return _Skip.apply(q, k, v)
    if not window or delta * n_local + n_local - 1 < window:
        return flash_attention_partial(q, k, v, causal=False, scale=scale)
    # The band's edge crosses the block: k positions sit delta * n_local
    # below this rank's queries.
    return _partial_banded(q, k, v, scale, -delta * n_local, window)


def _ring_attention_local(q, k, v, group, causal, scale, window):
    """Per-rank fold over the ring, [B, T/sp, H, D] shards in; the blocks
    run in [B, H, T, D] views (the kernels' layout)."""
    n = torch.distributed.get_world_size(group)
    rank = torch.distributed.get_rank(group)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    state = _empty_state(qT)
    for i in range(n):
        src = (rank - i) % n
        state = _fold(*state, *_block(qT, kT, vT, rank, src, q.shape[1],
                                      causal, scale, window))
        if i < n - 1:
            kT, vT = transport.ring_shift((kT, vT), group)
    o, l, _ = state
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, mesh, causal=True, scale=None, window=0):
    """Sequence-parallel attention over ``mesh``'s ``sp`` axis.

    q, k, v: this rank's shards [B/dp, T/sp, H, D] (the whole arrays
    without a mesh) -> this rank's output shard.  A mesh whose ``sp`` is
    1, or none, is ``attention_local``.  ``window`` > 0 = sliding-window
    causal attention; ring steps whose block lies outside the band skip
    compute.
    """
    _check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mesh is None or mesh.shape["sp"] == 1:
        return attention_local(q, k, v, causal=causal, scale=scale,
                               window=window)
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            "ring attention takes q, k, v shards of one shape, got %s, %s, "
            "%s" % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    return _ring_attention_local(q, k, v, mesh.group("sp"), causal, scale,
                                 window)

