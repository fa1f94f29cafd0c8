"""Point-to-point shifts, all-to-alls, all-reduces, broadcasts and
all-gathers over a process group, for the mesh paths (ring and Ulysses
attention, the SPMD and collective trainers' gradients, a re-formed
world's state, ZeRO-1's parameter shards).

How a tensor travels follows the group's backend, set by whoever built
the group (``parallel/mesh.py``):

 - ``nccl`` hands CUDA tensors to the collective as they are;
 - ``gloo`` takes CPU tensors only for point-to-point, so a CUDA tensor
   is copied to a host buffer first and the result copied back to the
   tensor's device; the all-to-all, the all-reduce, the broadcast and
   the all-gather go the same way.
   This is the route of ranks that share one card, which NCCL refuses.
   CPU tensors go as they are.

The two autograd Functions are the differentiable forms the attention
paths use: ``ring_shift`` (the JAX ``ppermute`` to the next rank; its
gradient is the shift back) and ``all_to_all`` (the JAX tiled
``all_to_all``, its own transpose).
"""

import torch
import torch.distributed as dist


def _staged(group, t):
    """Whether ``t`` goes through a host buffer on ``group``."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def shift(tensors, group, step=1):
    """Send each tensor to the rank ``step`` places on along ``group``'s
    ring and return the ones received from the rank ``step`` places back,
    with every send and receive posted together (two ranks never both
    wait on a send)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    outs, ops, landed = [], [], []
    for t in tensors:
        t = t.contiguous()
        if _staged(group, t):
            send, recv = t.cpu(), torch.empty(t.shape, dtype=t.dtype)
        else:
            send, recv = t, torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        landed.append((recv, t.device))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for recv, device in landed:
        outs.append(recv.to(device))
    return outs


def all_to_all_chunks(x, group):
    """x [n, ...] with n the group's size: chunk j goes to rank j, and
    chunk j of the result came from rank j."""
    x = x.contiguous()
    if _staged(group, x):
        out = torch.empty(x.shape, dtype=x.dtype)
        dist.all_to_all_single(out, x.cpu(), group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_sum_(tensors, group):
    """Sum ``tensors`` over ``group`` in place, through one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if _staged(group, flat):
        host = flat.cpu()
        dist.all_reduce(host, group=group)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_grads_(params, group, scalars=()):
    """Sum the gradients of ``params`` over ``group`` in place, with
    ``scalars`` (1-element tensors, summed in the same buffer); a
    parameter with no gradient contributes zeros and gets the sum.  One
    collective for the whole step: the data-parallel gradient reduction
    of the SPMD and collective trainers."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_sum_([p.grad for p in params] + list(scalars), group)


def broadcast_(tensors, group, src=0):
    """Overwrite ``tensors`` on every rank of ``group`` with rank
    ``src``'s (a rank of the group), bit for bit: one flat buffer per
    dtype, staged through the host as ``all_reduce_sum_`` stages."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    root = dist.get_global_rank(group, src)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        if _staged(group, flat):
            host = flat.cpu()
            dist.broadcast(host, root, group=group)
            flat = host.to(flat.device)
        else:
            dist.broadcast(flat, root, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_flat_(outs, shards, group):
    """Gather each rank's ``shards[i]`` (1-D, the same length on every
    rank of ``group``) into ``outs[i]`` (1-D, ``n`` times as long) on
    every rank, in rank order: one flat buffer per dtype, staged through
    the host as ``all_reduce_sum_`` stages.  The list form of
    ``all_gather``, which every torch that runs the port has."""
    n = dist.get_world_size(group)
    by_dtype = {}
    for out, shard in zip(outs, shards):
        if out.numel() != n * shard.numel():
            raise ValueError("a shard of %d elements gathers into %d, not "
                             "%d" % (shard.numel(), n * shard.numel(),
                                     out.numel()))
        by_dtype.setdefault(shard.dtype, []).append((out, shard))
    for same in by_dtype.values():
        flat = torch.cat([s.reshape(-1) for _, s in same])
        staged = _staged(group, flat)
        send = flat.cpu() if staged else flat
        rows = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(rows, send, group=group)
        for i, row in enumerate(rows):
            if staged:
                row = row.to(flat.device)
            offset = 0
            for out, shard in same:
                k = shard.numel()
                out.view(n, k)[i].copy_(row[offset:offset + k])
                offset += k


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(shift(grads, ctx.group, -1))


def ring_shift(tensors, group):
    """``shift`` one place on, differentiable: the gradient of what was
    received goes back to its sender, so every rank that applies it must
    also run its backward (see ``ring_attention``'s skipped blocks)."""
    return _RingShift.apply(group, *tensors)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return all_to_all_chunks(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, all_to_all_chunks(g, ctx.group)


def all_to_all(x, group):
    """``all_to_all_chunks``, differentiable (it is its own transpose)."""
    return _AllToAll.apply(group, x)
