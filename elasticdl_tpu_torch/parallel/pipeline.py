"""Microbatch pipeline parallelism over a mesh's ``pp`` axis (counterpart
of ``elasticdl_tpu/parallel/pipeline.py``).

S pipeline stages each hold 1/S of the layer stack, and M microbatches
stream through a GPipe schedule of M + S - 1 ticks, so stages compute
concurrently on different microbatches:

    tick:      0    1    2    3    4    5   ...
    stage 0:  m0   m1   m2   m3    -    -
    stage 1:   -   m0   m1   m2   m3    -
    stage 2:   -    -   m0   m1   m2   m3

Each stage is busy for M of the M + S - 1 ticks, so the bubble fraction
is (S - 1) / (M + S - 1).

The JAX function is one ``lax.scan`` inside ``shard_map``: every device
runs every tick, a bubble tick on clamped garbage (its shapes must be
static), and the activations hop stages with ``ppermute``.  Here each
rank is one stage, a process of the mesh, and runs the same M + S - 1
ticks as a Python loop: stage 0 injects microbatch t, a stage whose tick
holds a real microbatch runs its layers on it, the last stage commits
it, and the state hops one stage on with ``transport.ring_shift`` (the
``ppermute``, its reverse shift the gradient).  A bubble tick runs no
layer: it only shifts, to keep the ranks in lockstep, so a stage
launches its kernels M times a step, not M + S - 1.

Autograd gives the backward schedule, as differentiating the scan does
in JAX: the shifts form one chain on every rank (what stage 0 drops for
an injected microbatch, and the state no stage reads after the last
tick, are tied to the chain with a zero gradient), so every rank runs the
backward of every shift it ran forward, in the reverse order.  The last
stage's outputs reach every stage through ``transport.all_reduce`` of
the zero-masked outputs (the JAX ``psum``), with the aux in the same
call.  ``remat=True`` checkpoints ``stage_fn`` per microbatch
(``torch.utils.checkpoint``), the shift outside the checkpoint.

The caller's layers stay its own: ``stage_params`` is this stage's slice
of the stack (``spmd_trainer.block`` by a spec of ``("pp", ...)`` takes
it from the whole stack, with the JAX function's divisibility check),
and every other axis of the mesh is the caller's to use inside
``stage_fn`` (its tp or ep collectives run on the stage's ranks only,
which are in the same tick together).
"""

import torch
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.parallel import transport


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def _add_aux(total, aux):
    """The running float32 sum of a stage's aux trees."""
    aux = _tree_map(lambda a: a.float(), aux)
    return aux if total is None else _tree_add(total, aux)


class _Inject(torch.autograd.Function):
    """Stage 0's state for a new microbatch: ``x``, with what the shift
    brought in (``received``) tied to it by a zero gradient."""

    @staticmethod
    def forward(ctx, received, x):
        ctx.like = (received.shape, received.dtype, received.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device), g


class _ZerosLike(torch.autograd.Function):
    """Zeros of ``shape`` tied to ``tied`` by a zero gradient: a stage's
    contribution to the masked broadcast of the last stage's outputs,
    which keeps its last received state in the chain."""

    @staticmethod
    def forward(ctx, tied, shape):
        ctx.like = (tied.shape, tied.dtype, tied.device)
        return torch.zeros(shape, dtype=tied.dtype, device=tied.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device), None


def _run_local(fn, stage_params, x, M, with_aux):
    """One stage, no shifts: every microbatch through ``fn`` in turn."""
    outs, aux_total = [], None
    for t in range(M):
        result = fn(stage_params, x[t])
        if with_aux:
            y, aux = result
            aux_total = _add_aux(aux_total, aux)
        else:
            y = result
        outs.append(y)
    return torch.stack(outs), aux_total


def _spmd_pipeline(fn, stage_params, x, group, stage, S, M, with_aux):
    """The per-rank body: this stage's ticks.  Returns (this stage's
    [M, ...] outputs, real on the last stage only, or None elsewhere;
    the state the last tick left; the aux summed over real ticks)."""
    state = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device,
                        requires_grad=torch.is_grad_enabled())
    outs, aux_total = [None] * M, None
    for t in range(M + S - 1):
        if stage == 0 and t < M:
            state = _Inject.apply(state, x[t])
        mb = t - stage
        if 0 <= mb < M:
            result = fn(stage_params, state)
            if with_aux:
                state, aux = result
                aux_total = _add_aux(aux_total, aux)
            else:
                state = result
            if stage == S - 1:
                outs[mb] = state
        if t < M + S - 2:
            # The JAX loop's shift after the last tick is dropped, as
            # ring attention drops its last.
            state, = transport.ring_shift((state,), group)
    return (torch.stack(outs) if stage == S - 1 else None), state, aux_total


def pipeline_apply(stage_fn, stage_params, x, *, mesh, num_microbatches,
                   axis="pp", remat=False, with_aux=False,
                   aux_finalize=None):
    """Apply a stacked-layer model as an S-stage microbatch pipeline over
    ``mesh``'s ``axis`` (S its size).

    stage_fn: (this stage's params, x_mb) -> y_mb, or (y_mb, aux) where
        aux is a tensor or a tree of them (summed over this stage's real
        microbatches, in float32).  With ``with_aux=True`` the call
        returns (y, aux_out):
        - default: aux is a scalar; aux_out = the sum over stages of
          (the stage's aux sum / M), the per-microbatch mean;
        - ``aux_finalize(aux_tree, M) -> scalar`` runs per stage on its
          sum before the cross-stage sum: how a caller recovers exact
          full-batch statistics that are not linear in the batch.
    stage_params: this stage's slice of the layer stack.
    x: [M, microbatch...], the caller's microbatches (``split_microbatches``);
        only stage 0 reads its values, the other stages its shape.

    Returns [M, microbatch...] outputs on every stage.
    """
    S = mesh.shape[axis] if mesh is not None else 1
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")
    if x.shape[0] != num_microbatches:
        raise ValueError(
            "x leading dim %d != num_microbatches %d"
            % (x.shape[0], num_microbatches))
    M = num_microbatches
    fn = stage_fn
    if remat and torch.is_grad_enabled():
        def fn(params, x_mb):
            return checkpoint(stage_fn, params, x_mb, use_reentrant=False)
    if S == 1:
        y, aux_total = _run_local(fn, stage_params, x, M, with_aux)
    else:
        group = mesh.group(axis)
        stage = mesh.coords[axis]
        y, last_state, aux_total = _spmd_pipeline(
            fn, stage_params, x, group, stage, S, M, with_aux)
        if y is None:
            y = _ZerosLike.apply(last_state, tuple(x.shape))
    if with_aux:
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
        stage_aux = (aux_finalize(aux_total, M) if aux_finalize is not None
                     else aux_total / M)
    else:
        stage_aux = None
    if S > 1:
        # Only the last stage holds the outputs; the others add zeros, so
        # the sum is its outputs on every stage.  The aux sums over the
        # stages, which own disjoint layers.
        tensors = (y,) if stage_aux is None else (y, stage_aux)
        summed = transport.all_reduce(tensors, group)
        y = summed[0]
        if stage_aux is not None:
            stage_aux = summed[1]
    return (y, stage_aux) if with_aux else y


def split_microbatches(batch, num_microbatches):
    """[B, ...] -> [M, B/M, ...] along dim 0 (each tensor of a tree)."""
    def split(a):
        if a.shape[0] % num_microbatches:
            raise ValueError(
                "batch dim %d not divisible by %d microbatches"
                % (a.shape[0], num_microbatches))
        return a.reshape((num_microbatches, a.shape[0] // num_microbatches)
                         + tuple(a.shape[1:]))

    return _tree_map(split, batch)


def merge_microbatches(batch):
    """[M, mb, ...] -> [M*mb, ...] (each tensor of a tree)."""
    return _tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:])),
        batch)
