"""Flagship decoder-only transformer LM: serving and training
(counterpart of ``elasticdl_tpu/models/transformer.py``).

Pre-norm RMSNorm, RoPE positions, SwiGLU MLP, tied embeddings by default,
grouped-query attention (``num_kv_heads``) and sliding-window causal
attention (``window``), and a top-k mixture-of-experts FFN
(``moe_experts``).  Prompt attention (``forward``, ``prefill``) runs
on the flash attention kernels through ``parallel.ring_attention``, and
their backward kernels when training; decode attends one query against
the KV cache in plain PyTorch, as the JAX package does in jnp.  The MoE
dispatch, experts and combine are einsums in plain PyTorch, as the JAX
package computes them outside any Pallas kernel.

Parameters are stacked on a leading [num_layers] axis exactly as the JAX
pytree holds them (``layers.wq`` is [L, E, H*D]) and stay float32; every
use casts them to ``cfg.dtype``, as the JAX code does (``generate``
casts them once per call: the same values), so the gradients reach the
float32 master weights through those casts.  The JAX ``lax.scan`` over
layers is a Python loop; ``remat`` wraps each layer in
``torch.utils.checkpoint`` where the JAX code wraps it in
``jax.checkpoint``: ``True`` keeps only the layer's input, and the two
policies keep what the JAX policies keep, through selective
checkpointing (``_REMAT_POLICIES``).  The chunked cross-entropy
checkpoints each chunk the same way.  Both policies, as remat=True,
recompute the layer's attention forward in the backward, as the JAX
package does: the flash Function's (l, m) are not kept.

With a mesh (``parallel/mesh.py``), ``forward`` and ``forward_hidden``
run one rank's part of the step on its shards of the parameters
(``shard_params``, by ``param_specs``) and of the batch: tokens
[B/dp, T/sp] at RoPE positions offset by the rank's place along ``sp``.
 - ``sp``: attention as ring attention (B3p; ``attention_impl="ring"``)
   or Ulysses (B3/B4/B5 on the gathered sequence; ``"ulysses"``).
 - ``tp``, the Megatron splits: ``wq``/``wk``/``wv``/``w_gate``/``w_up``
   by column (this rank's heads and share of the FFN), ``wo``/``w_down``
   by row, their partial products summed over ``tp``
   (``transport.all_reduce``, whose gradient is the same sum); ``embed``
   held on the model dimension and gathered whole for the lookup and the
   tied head (``_cast``; the gradient: the reduce-scatter).  GSPMD splits
   any width; here the heads H and the K/V heads G must divide by ``tp``
   (a ``ValueError`` names them).
 - ``ep``: an MoE rank builds dispatch and combine for its own experts
   and sums its output over ``ep`` (and ``tp``).  The router statistics
   of the aux loss are summed over ``dp`` and ``sp`` before the product,
   so the aux is the global batch's, as GSPMD computes it; under ``sp``
   an expert slot counts the tokens of the earlier shards (one gather of
   the per-expert counts a choice), and capacity is sized over the whole
   sequence, so the dispatch is the JAX one exactly.
 - ``pp``: each rank holds its stage's layers; ``forward`` runs them as a
   pipeline of one microbatch and ``forward_pipelined`` as a GPipe
   schedule of M (``parallel/pipeline.py``).  The JAX stage runs
   attention in plain jnp (``attention_mode="off"``: a ``pallas_call``
   under GSPMD's auto axes would be all-gathered); a port stage on the
   card launches the flash kernels (B3, and B4/B5 in the backward), as
   every other path does.
``parallel/spmd_trainer.py`` sums each gradient over the axes its spec
does not name.  The collective trainer trains the LM over a world with no
mesh in the spec (its gradients are all-reduced,
``worker/collective_trainer.py``); it runs each forward inside
``parallel.mesh.batch_split`` of its world (``Mesh.flat``), and an MoE
model's forward runs over that mesh of ``dp`` alone, so the router
statistics are the global batch's there too.
"""

import dataclasses
import functools
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.parallel import transport
from elasticdl_tpu_torch.parallel.mesh import batch_split_mesh
from elasticdl_tpu_torch.parallel.pipeline import (
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
)
from elasticdl_tpu_torch.parallel.ring_attention import ring_attention
from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention
from elasticdl_tpu_torch.utils import metrics

NEG_INF_DECODE = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Sequence-parallel strategies over the mesh's ``sp`` axis.
_ATTENTION = {"ring": ring_attention, "ulysses": ulysses_attention}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 512
    num_heads: int = 8
    num_layers: int = 4
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    tied_embeddings: bool = True
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    remat: bool | str = False
    attention_impl: str = "ring"
    # Sliding-window causal attention: 0 = full causal; W > 0 keeps only
    # the last W positions.
    window: int = 0
    # Grouped-query attention: 0 = MHA; G > 0 projects K/V to G heads,
    # query head i attends kv head i // (H/G).
    num_kv_heads: int = 0

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError("dtype must be one of %s, got %r"
                             % (sorted(_DTYPES), self.dtype))
        if self.remat not in (False, True, "dots", "attn"):
            raise ValueError("remat must be one of False, True, 'dots', "
                             "'attn'; got %r" % (self.remat,))
        if self.attention_impl not in _ATTENTION:
            raise ValueError(
                "unknown attention_impl %r (want 'ring' or 'ulysses')"
                % (self.attention_impl,))

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def kv_heads(self):
        """Effective K/V head count (num_kv_heads=0 -> MHA)."""
        kv = self.num_kv_heads or self.num_heads
        if kv <= 0 or self.num_heads % kv:
            raise ValueError(
                "num_heads (%d) must be a positive multiple of "
                "num_kv_heads (%d)" % (self.num_heads, kv))
        return kv

    @property
    def mlp_dim(self):
        return self.dim * self.mlp_ratio

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]


def _check_mesh(mesh, cfg):
    """The widths a mesh's ``tp`` and ``ep`` split must divide by them."""
    if mesh is None:
        return
    tp, ep = mesh.shape["tp"], mesh.shape["ep"]
    if cfg.num_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            "tp=%d splits the attention heads: num_heads (%d) and the K/V "
            "heads (%d) must both divide by it" % (tp, cfg.num_heads,
                                                   cfg.kv_heads))
    widths = {"dim": cfg.dim, "mlp_dim": cfg.mlp_dim}
    if not cfg.tied_embeddings:
        widths["vocab_size"] = cfg.vocab_size
    bad = {k: v for k, v in widths.items() if v % tp}
    if bad:
        raise ValueError("tp=%d does not divide %s" % (tp, bad))
    if cfg.moe_experts and cfg.moe_experts % ep:
        raise ValueError("ep=%d does not divide moe_experts (%d)"
                         % (ep, cfg.moe_experts))


def _live(mesh, axes):
    """The group over ``axes``, or None without a mesh or where they are
    all 1."""
    return mesh.group(axes) if mesh is not None else None


def _sum_over(x, mesh, axes):
    """``x`` summed over the mesh's ``axes`` (differentiable); ``x`` where
    there is nothing to sum over."""
    group = _live(mesh, axes)
    return x if group is None else transport.all_reduce((x,), group)[0]


# -- parameters ---------------------------------------------------------------


class TransformerLM(torch.nn.Module):
    """The parameters, named as the JAX pytree names them (``embed``,
    ``layers.wq``, ``ln_f``; ``lm_head`` when untied).  ``forward`` is
    :func:`forward`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        L, E, H, D, F_ = (cfg.num_layers, cfg.dim, cfg.num_heads,
                          cfg.head_dim, cfg.mlp_dim)
        G = cfg.kv_heads

        def empty(*shape):
            return torch.nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device))

        self.embed = empty(cfg.vocab_size, E)
        self.layers = torch.nn.Module()
        shapes = [("ln1", (L, E)), ("wq", (L, E, H * D)),
                  ("wk", (L, E, G * D)), ("wv", (L, E, G * D)),
                  ("wo", (L, H * D, E)), ("ln2", (L, E))]
        X = cfg.moe_experts
        if X:
            shapes += [("w_router", (L, E, X)), ("w_gate", (L, X, E, F_)),
                       ("w_up", (L, X, E, F_)), ("w_down", (L, X, F_, E))]
        else:
            shapes += [("w_gate", (L, E, F_)), ("w_up", (L, E, F_)),
                       ("w_down", (L, F_, E))]
        for name, shape in shapes:
            setattr(self.layers, name, empty(*shape))
        self.ln_f = empty(E)
        if not cfg.tied_embeddings:
            self.lm_head = empty(E, cfg.vocab_size)

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def init_params(generator, cfg, device=None):
    """A :class:`TransformerLM` with the JAX ``init_params`` families drawn
    from ``generator`` (a ``torch.Generator`` on ``device``): norms 1,
    dense kernels N(0, 1/fan_in) with fan_in the second-to-last axis,
    ``embed`` (and ``lm_head``, ``w_router``) N(0, 0.02^2)."""
    module = TransformerLM(cfg, device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in ("ln_f", "layers.ln1", "layers.ln2"):
                p.fill_(1.0)
                continue
            std = (0.02 if name in ("embed", "lm_head", "layers.w_router")
                   else 1.0 / math.sqrt(p.shape[-2]))
            p.normal_(0.0, std, generator=generator)
    return module


def _named(params):
    """(name, tensor) pairs of a :class:`TransformerLM` or of a dict in
    its names (``models.lora`` hands its merged weights in as one)."""
    return (params.items() if isinstance(params, dict)
            else params.named_parameters())


def _cast(params, cfg, names=None, mesh=None):
    """{name: parameter in the compute dtype}: what each use in the JAX
    code casts (``w["wq"].astype(compute_dtype)``); only ``names`` when
    given.  Under tp the embedding and an untied head, held as [V, E/tp]
    and [E, V/tp] blocks, are gathered whole along dim 1 (their gradient:
    the reduce-scatter), so the lookup and the head are the single
    process's: 64 MB of bf16 weights on the wire at the flagship's widths,
    where the partial logits' sum would move a 1 GB [8, 2048, 32768]
    tensor each way."""
    dtype = cfg.compute_dtype
    w = {name: p.to(dtype) for name, p in _named(params)
         if names is None or name in names}
    group = _live(mesh, ("tp",))
    if group is not None:
        for name in ("embed", "lm_head"):
            if name in w:
                w[name] = transport.all_gather(w[name], group, 1)
    return w


def _layer(w, i):
    return {name[len("layers."):]: p[i] for name, p in w.items()
            if name.startswith("layers.")}


# -- forward ------------------------------------------------------------------


def _rmsnorm(x, scale):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _rope(x, positions):
    """Rotary embeddings; x: [B, T, H, D], positions: [T]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _ffn(h, w):
    gate = F.silu(h @ w["w_gate"])
    return (gate * (h @ w["w_up"])) @ w["w_down"]


def _top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    toward the lower index (a stable sort; ``torch.topk`` promises no
    order among equal values)."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def _moe_ffn(h, w, cfg, mesh=None):
    """Top-k mixture-of-experts FFN (the JAX ``_moe_ffn``).

    Dense dispatch and combine over one-hot capacity slots per sequence:
    choice 0 has priority, and choice j's slots start after the tokens
    every earlier choice sent to that expert; a token past an expert's
    capacity falls to its other choices or to the residual.  Dispatch
    and combine run in float32, the experts in the compute dtype.
    Returns (out [B, T, E] in h's dtype, aux, stats): aux is the Switch
    load-balance loss X * sum_x frac_top1(x) * mean_prob(x), taken from
    the top-1 assignment before capacity, and stats the [2, X] stack of
    those two statistics.

    With a mesh, ``h`` is this rank's [B/dp, T/sp] shard and ``w`` holds
    its experts (``ep``) and its share of their FFN (``tp``): the
    statistics are means over the global batch (sums over ``dp`` and
    ``sp``), a slot position counts the earlier ``sp`` shards' tokens,
    capacity is sized over the whole sequence, and the output is summed
    over ``ep`` and ``tp``."""
    B, T, _ = h.shape
    X = cfg.moe_experts
    K = min(cfg.moe_top_k, X)
    sp = mesh.shape["sp"] if mesh is not None else 1
    T_all = T * sp
    capacity = max(1, min(T_all,
                          int(T_all * K * cfg.moe_capacity_factor / X) + 1))
    probs = torch.softmax((h @ w["w_router"]).float(), dim=-1)   # [B,T,X]

    top1 = F.one_hot(probs.argmax(dim=-1), X).float()
    batch_group = _live(mesh, ("dp", "sp"))
    if batch_group is None:
        stats = torch.stack([top1.mean(dim=(0, 1)), probs.mean(dim=(0, 1))])
    else:
        sums = torch.stack([top1.sum(dim=(0, 1)), probs.sum(dim=(0, 1))])
        sums, = transport.all_reduce((sums,), batch_group)
        stats = sums / (B * T * mesh.size(("dp", "sp")))
    aux = X * (stats[0] * stats[1]).sum()

    gate_vals, experts = _top_k(probs, K)                        # [B,T,K]
    if K > 1:
        # GShard renormalisation over the chosen experts; top-1 keeps the
        # raw gate (Switch), which keeps the router in the task loss.
        gate_vals = gate_vals / gate_vals.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)

    # This rank's experts: [e0, e0 + X_local).
    X_local = w["w_gate"].shape[0]
    e0 = mesh.coords["ep"] * X_local if mesh is not None else 0
    sp_group = _live(mesh, ("sp",))
    disp = combine = 0.0                                 # [B,T,X_local,C]
    offset = h.new_zeros((B, 1, X), dtype=torch.float32)
    for j in range(K):
        onehot = F.one_hot(experts[..., j], X).float()          # [B,T,X]
        counts = onehot.sum(dim=1, keepdim=True)                # [B,1,X]
        pos = torch.cumsum(onehot, dim=1) - 1.0 + offset
        if sp_group is not None:
            # The tokens the earlier shards of the sequence sent.
            every = transport.gather_along(counts[None], sp_group, 0)
            pos = pos + every[:mesh.coords["sp"]].sum(dim=0)
            counts = every.sum(dim=0)
        onehot, pos = onehot[..., e0:e0 + X_local], pos[..., e0:e0 + X_local]
        keep = onehot * (pos < capacity)
        # keep x one_hot(slot), without a [B, T, X, C] int64 one-hot
        slot = torch.zeros((B, T, X_local, capacity), dtype=torch.float32,
                           device=h.device).scatter(
            -1, pos.clamp(0, capacity - 1).long()[..., None],
            keep[..., None])
        disp = disp + slot
        combine = combine + gate_vals[..., j, None, None] * slot
        offset = offset + counts
    xin = torch.einsum("btxc,bte->xbce", disp, h.float()).to(h.dtype)
    g = F.silu(torch.einsum("xbce,xef->xbcf", xin, w["w_gate"]))
    u = torch.einsum("xbce,xef->xbcf", xin, w["w_up"])
    y = torch.einsum("xbcf,xfe->xbce", g * u, w["w_down"])
    out = torch.einsum("btxc,xbce->bte", combine, y.float())
    out = _sum_over(out, mesh, ("ep", "tp"))
    return out.to(h.dtype), aux, stats


def _mlp(h, w, cfg):
    """The layer's FFN: (out, MoE aux or None)."""
    if cfg.moe_experts:
        out, aux, _ = _moe_ffn(h, w, cfg)
        return out, aux
    return _ffn(h, w), None


@torch.library.custom_op("elasticdl_tpu_torch::checkpoint_name",
                         mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: x, as one op that a remat
    policy can keep by ``name``.  A custom op returns no alias of its
    input, so this is a copy."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def _layer_body(x, w, cfg, positions, mesh=None, return_kv=False,
                moe_stats=False):
    """One block over a sequence, or this rank's shard of it with a mesh
    (weights ``w`` of one layer, in the compute dtype, this rank's blocks
    of them) -> (x, MoE aux or None; the [2, X] router statistics with
    ``moe_stats``, which the pipeline accumulates).  ``return_kv`` also
    returns this layer's post-RoPE, pre-GQA-expand (k, v) [B, T, G, D]
    for the KV cache, as (x, aux, (k, v))."""
    B, T = x.shape[0], x.shape[1]
    D = cfg.head_dim
    h = _rmsnorm(x, w["ln1"])
    # This rank's heads under tp: H/tp query heads, G/tp K/V heads.
    q = _rope((h @ w["wq"]).reshape(B, T, -1, D), positions)
    k = _rope((h @ w["wk"]).reshape(B, T, -1, D), positions)
    v = (h @ w["wv"]).reshape(B, T, -1, D)
    H, G = q.shape[2], k.shape[2]
    kv = (k, v)
    if G != H:
        # jnp.repeat order: head i attends kv head i // (H/G).
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    attn = _ATTENTION[cfg.attention_impl](q, k, v, mesh, causal=True,
                                          window=cfg.window)
    attn = attn.reshape(B, T, H * D)
    if cfg.remat == "attn" and torch.is_grad_enabled():
        attn = checkpoint_name(attn, "attn_out")
    x = x + _sum_over(attn @ w["wo"], mesh, ("tp",))
    h = _rmsnorm(x, w["ln2"])
    if cfg.moe_experts:
        out, aux, stats = _moe_ffn(h, w, cfg, mesh)
        if moe_stats:
            aux = stats
    else:
        out, aux = _sum_over(_ffn(h, w), mesh, ("tp",)), None
    x = x + out
    return (x, aux, kv) if return_kv else (x, aux)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the products with no batch dimension, the weight products ``h @ W``
    that PyTorch runs as ``mm`` (``addmm`` with a bias); recompute the
    rest, the batched MoE einsums (``bmm``) among them."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_attn_out(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out")``: keep the attention output
    that ``_layer_body`` names, recompute everything else."""
    if (op is torch.ops.elasticdl_tpu_torch.checkpoint_name.default
            and args[1] == "attn_out"):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {"dots": _save_matmuls, "attn": _save_attn_out}


def _checkpointed_layer(x, w, cfg, positions, mesh, moe_stats=False):
    """``_layer_body`` under ``torch.utils.checkpoint``: remat=True keeps
    only the layer's input, a policy also what it names.  Under a mesh the
    recompute repeats the layer's collectives (ring shifts, all-to-alls,
    the tp and ep sums) on every rank, in the same order."""
    policy = _REMAT_POLICIES.get(cfg.remat)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    policy) if policy is not None
                  else torch.utils.checkpoint.noop_context_fn)
    return checkpoint(_layer_body, x, w, cfg, positions, mesh, False,
                      moe_stats, use_reentrant=False, context_fn=context_fn)


def _head(w, x, cfg):
    x = _rmsnorm(x, w["ln_f"])
    head = w["embed"].T if cfg.tied_embeddings else w["lm_head"]
    return (x @ head).float()


def _positions(tokens, mesh):
    """RoPE positions of this rank's tokens: the JAX code's arange(T) over
    the global sequence, of which a rank holds the ``sp`` coordinate's
    block."""
    t = tokens.shape[1]
    start = mesh.coords["sp"] * t if mesh is not None else 0
    return torch.arange(start, start + t, device=tokens.device)


def _stacked(w):
    return {name[len("layers."):]: p for name, p in w.items()
            if name.startswith("layers.")}


def _layers_of(stack, x, cfg, positions, mesh, layer_remat, moe_stats):
    """This rank's layers of ``stack`` over ``x``: (x, per-layer aux or
    router statistics)."""
    auxes = []
    for i in range(next(iter(stack.values())).shape[0]):
        w = {name: p[i] for name, p in stack.items()}
        if layer_remat:
            x, aux = _checkpointed_layer(x, w, cfg, positions, mesh,
                                         moe_stats)
        else:
            x, aux = _layer_body(x, w, cfg, positions, mesh,
                                 moe_stats=moe_stats)
        auxes.append(aux)
    return x, auxes


def _forward_hidden(w, tokens, cfg, mesh=None, microbatches=0,
                    stage_remat=False):
    """(final hidden, mean per-layer MoE aux; 0 for the dense FFN).  Over
    a mesh with pp > 1, or with ``microbatches``, the layers run as a
    pipeline (``forward_pipelined``): of ``microbatches`` microbatches
    (1 without), each stage under one checkpoint with ``stage_remat``,
    each layer under its own with the config's remat otherwise."""
    stack = _stacked(w)
    positions = _positions(tokens, mesh)
    layer_remat = bool(cfg.remat) and torch.is_grad_enabled()
    moe = bool(cfg.moe_experts)
    pp = mesh.shape["pp"] if mesh is not None else 1
    if pp == 1 and not microbatches:
        x, auxes = _layers_of(stack, w["embed"][tokens], cfg, positions,
                              mesh, layer_remat, False)
        if moe:
            return x, torch.stack(auxes).mean()
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    M = microbatches or 1
    if pp == 1 or mesh.coords["pp"] == 0:
        x = w["embed"][tokens]
    else:
        # Only stage 0 reads the microbatches' values.
        x = torch.empty(tuple(tokens.shape) + (cfg.dim,),
                        dtype=cfg.compute_dtype, device=tokens.device)
    layer_remat = layer_remat and not stage_remat

    def stage_fn(stage_stack, x_mb):
        x_mb, stats = _layers_of(stage_stack, x_mb, cfg, positions, mesh,
                                 layer_remat, moe)
        return (x_mb, torch.stack(stats)) if moe else x_mb

    def finalize(stats, num_mb):
        # stats: [L_stage, 2, X] sums of per-microbatch (frac, prob)
        # means; / M gives the full batch's, so this stage's layers
        # contribute their exact Switch aux, whatever M is.
        f = stats[:, 0] / num_mb
        p = stats[:, 1] / num_mb
        return (cfg.moe_experts * (f * p).sum(-1)).sum()

    out = pipeline_apply(stage_fn, stack, split_microbatches(x, M),
                         mesh=mesh, num_microbatches=M, remat=stage_remat,
                         with_aux=moe, aux_finalize=finalize)
    if moe:
        ym, aux_sum = out
        # The sum covers every layer (the stages sum theirs): the mean
        # per layer, as forward(return_aux=True) gives.
        return merge_microbatches(ym), aux_sum / cfg.num_layers
    return merge_microbatches(out), torch.zeros(
        (), dtype=torch.float32, device=tokens.device)


def forward_hidden(params, tokens, cfg, mesh=None):
    """tokens: [B, T] int -> (final hidden [B, T, dim] before ``ln_f``
    and the head, mean per-layer MoE aux loss), as the JAX function
    returns them; the dense FFN's aux is 0.  With a mesh, tokens and
    hidden are this rank's shards [B/dp, T/sp] and ``params`` its blocks
    (``shard_params``)."""
    _check_mesh(mesh, cfg)
    return _forward_hidden(_cast(params, cfg, mesh=mesh), tokens, cfg, mesh)


def forward(params, tokens, cfg, mesh=None, return_aux=False):
    """tokens: [B, T] int -> logits [B, T, V] float32; with
    ``return_aux`` (training an MoE), (logits, mean per-layer aux).  With
    a mesh, tokens and logits are this rank's shards [B/dp, T/sp] and
    ``params`` its blocks (``shard_params``)."""
    _check_mesh(mesh, cfg)
    w = _cast(params, cfg, mesh=mesh)
    hidden, aux = _forward_hidden(w, tokens, cfg, mesh)
    logits = _head(w, hidden, cfg)
    return (logits, aux) if return_aux else logits


def forward_pipelined(params, tokens, cfg, mesh, num_microbatches,
                      remat=False, return_aux=False, return_hidden=False):
    """Microbatch-pipelined forward over the ``pp`` mesh axis.

    The layer stack runs as a GPipe schedule (``parallel/pipeline.py``):
    S = mesh.shape['pp'] stages, each this rank's layers, compute on
    different microbatches, activations hopping stages by ring shifts;
    the bubble fraction is (S-1)/(M+S-1).  ``remat`` checkpoints each
    stage per microbatch.  With ``return_aux`` the MoE load-balance loss
    equals the exact full-batch Switch statistic: the stages accumulate
    the linear per-expert (frac, prob) statistics over their real ticks
    and combine them after the loop.  The embedding lookup and the head
    run outside the pipeline on every stage (the head on the merged
    hidden states, so ``return_hidden`` composes with the chunked loss).
    Attention is stage-local, so this path requires sp=1; dp, tp and ep
    compose inside the stages."""
    if mesh.shape.get("sp", 1) != 1:
        raise ValueError(
            "forward_pipelined requires sp=1 (stage-local attention); use "
            "ring attention (plain forward) for sequence parallelism")
    _check_mesh(mesh, cfg)
    w = _cast(params, cfg, mesh=mesh)
    hidden, aux = _forward_hidden(w, tokens, cfg, mesh,
                                  microbatches=num_microbatches,
                                  stage_remat=bool(remat))
    out = hidden if return_hidden else _head(w, hidden, cfg)
    return (out, aux) if return_aux else out


# -- autoregressive decoding --------------------------------------------------


def init_kv_cache(cfg, batch, max_len, device=None):
    """Zeroed K/V caches, each [L, B, max_len, G, D] in the compute dtype
    (G = cfg.kv_heads)."""
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _decode_layer(x, w, cfg, ck, cv, pos):
    """One block for ONE position.  x: [B, 1, E]; ck, cv: this layer's
    [B, max, G, D] caches, written at ``pos`` in place (the JAX code
    returns updated copies).  Attention is the single query against the
    cache positions 0..pos in f32, grouped (no K/V head repeat)."""
    B = x.shape[0]
    H, D, G = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    positions = torch.full((1,), pos, device=x.device)
    h = _rmsnorm(x, w["ln1"])
    q = _rope((h @ w["wq"]).reshape(B, 1, H, D), positions)
    ck[:, pos] = _rope((h @ w["wk"]).reshape(B, 1, G, D), positions)[:, 0]
    cv[:, pos] = (h @ w["wv"]).reshape(B, G, D)

    # Positions past ``pos`` are masked in the JAX code; their
    # probabilities are exactly 0, so they are left out here.
    keys, values = ck[:, :pos + 1].float(), cv[:, :pos + 1].float()
    qg = q.reshape(B, G, H // G, D).float()
    s = torch.einsum("bgrd,btgd->bgrt", qg, keys) * (D ** -0.5)
    if cfg.window:
        idx = torch.arange(pos + 1, device=x.device)
        s = torch.where(pos - idx < cfg.window, s,
                        torch.full_like(s, NEG_INF_DECODE))
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum("bgrt,btgd->bgrd", p, values).reshape(
        B, 1, H * D).to(x.dtype)
    x = x + attn @ w["wo"]
    return x + _mlp(_rmsnorm(x, w["ln2"]), w, cfg)[0]


def _prefill(w, cfg, prompt, max_len):
    b, tp = prompt.shape
    x = w["embed"][prompt]
    positions = torch.arange(tp, device=x.device)
    ck, cv = init_kv_cache(cfg, b, max_len, device=x.device)
    for i in range(cfg.num_layers):
        x, _, (k, v) = _layer_body(x, _layer(w, i), cfg, positions,
                                   return_kv=True)
        ck[i, :, :tp] = k
        cv[i, :, :tp] = v
    # The head of the last position only: rows are independent, so this
    # is the JAX code's head over all positions, then [:, -1].
    return _head(w, x[:, -1:], cfg)[:, 0], (ck, cv)


def prefill(params, cfg, prompt, max_len):
    """Batched prefill: one forward over the prompt [B, Tp] writes every
    layer's K/V into fresh caches of length ``max_len``.  Returns
    (last-position logits [B, V] float32, (ck, cv))."""
    return _prefill(_cast(params, cfg), cfg, prompt, max_len)


def _decode_step(w, cfg, caches, pos, tokens_1):
    ck, cv = caches
    x = w["embed"][tokens_1][:, None, :]
    for i in range(cfg.num_layers):
        x = _decode_layer(x, _layer(w, i), cfg, ck[i], cv[i], pos)
    return _head(w, x, cfg)[:, 0], caches


def decode_step(params, cfg, caches, pos, tokens_1):
    """One decode step: tokens_1 [B] at position ``pos`` -> (logits [B, V]
    float32, caches), the caches updated in place."""
    return _decode_step(_cast(params, cfg), cfg, caches, pos, tokens_1)


_U64 = (1 << 64) - 1


def _int64(value):
    """A uint64 value as the int64 with the same bits."""
    value &= _U64
    return value - (1 << 64) if value >> 63 else value


def _srl(z, k):
    """Logical right shift of an int64 tensor read as uint64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(z):
    """splitmix64's mix of an int64 tensor read as uint64: multiply and
    xor wrap as uint64's do, the shifts are logical."""
    z = z + _int64(0x9E3779B97F4A7C15)
    z = (z ^ _srl(z, 30)) * _int64(0xBF58476D1CE4E5B9)
    z = (z ^ _srl(z, 27)) * _int64(0x94D049BB133111EB)
    return z ^ _srl(z, 31)


def _step_key(seed, step):
    """The int64 key of one sampling step: (seed, step) mixed on the
    host, splitmix64 of the 32-bit seed over the step."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return _int64(z ^ (z >> 31))


def _step_uniforms(index, seed, step):
    """Uniforms in (0, 1), float32, one per element of ``index`` (int64
    element indices): the top 24 bits of splitmix64 of the index plus
    the step's key, at the centre of their bin.  Counter-based, so an
    element's value depends on (seed, step, index) alone and is the same
    on every device; no host work beyond the key."""
    bits = _srl(_splitmix64(index + _step_key(seed, step)), 40)
    return (bits.float() + 0.5) * 2.0 ** -24


def generate(params, cfg, prompt, max_new_tokens, temperature=0.0, seed=0):
    """Autoregressive generation: batched prefill + KV-cache decode.

    prompt: [B, Tp] int, Tp >= 1 (seed unconditional generation with a
    BOS token).  Returns int32 [B, Tp + max_new_tokens] on the params'
    device; greedy when ``temperature`` == 0 (ties take the first
    index, as in JAX), else softmax sampling at the given temperature by
    the Gumbel-max rule, as ``jax.random.categorical`` samples.  The
    uniforms are counter-based (``_step_uniforms``): element (i, j) of a
    step's [B, V] noise hashes (seed, step) and its index i V + j, on the
    logits' device.  Row i's noise then depends on its place and not on
    the batch size: as in the JAX package, a row's tokens depend on the
    seed and on its place in the batch, not on the rows after it (a
    batcher's padding), and equal seeds reproduce exactly on any device.
    The tokens cannot equal the JAX package's, whose random stream
    differs.
    """
    device = params.embed.device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, tp = prompt.shape
    if tp == 0:
        raise ValueError(
            "prompt must have at least one token (use a BOS token for "
            "unconditional generation)")
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens == 0:
        return prompt.int()
    total = tp + max_new_tokens

    index = []      # the [B, V] element indices, made at the first step

    def sample(logits, step):
        if not temperature:
            return logits.argmax(dim=-1)
        if not index:
            index.append(torch.arange(
                logits.numel(), dtype=torch.long,
                device=logits.device).view(logits.shape))
        u = _step_uniforms(index[0], seed, step)
        gumbel = -torch.log(-torch.log(u))
        return (logits / temperature + gumbel).argmax(dim=-1)

    with torch.no_grad():
        w = _cast(params, cfg)
        logits, caches = _prefill(w, cfg, prompt, total)
        tokens = torch.cat(
            [prompt, torch.zeros((b, max_new_tokens), dtype=torch.long,
                                 device=device)], dim=1)
        tokens[:, tp] = sample(logits, tp)
        for t in range(tp, total - 1):
            logits, caches = _decode_step(w, cfg, caches, t, tokens[:, t])
            tokens[:, t + 1] = sample(logits, t + 1)
    return tokens.int()


# -- training losses ----------------------------------------------------------


def next_token_loss(logits, tokens):
    """Per-example mean next-token cross entropy; logits [B, T, V] float32,
    tokens [B, T] -> [B]."""
    b, t, vocab = logits.shape
    per_tok = F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                              tokens[:, 1:].reshape(-1).long(),
                              reduction="none")
    return per_tok.reshape(b, t - 1).mean(dim=-1)


def _chunk_xent_sum(w, h_c, t_c, m_c, cfg):
    logits = _head(w, h_c, cfg)                       # [B, chunk, V] f32
    per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              t_c.reshape(-1), reduction="none")
    return (per_tok.reshape(t_c.shape) * m_c[None, :]).sum(dim=-1)


def next_token_loss_chunked(params, hidden, tokens, cfg, chunk=512,
                            mesh=None):
    """Next-token cross entropy from :func:`forward_hidden`'s hidden
    [B, T, E] without a [B, T, V] logits tensor: ln_f, the head matmul and
    the cross entropy run per T-chunk under ``torch.utils.checkpoint``,
    so the live logits are [B, chunk, V] in both directions (the backward
    recomputes each chunk's).  The same padding and mask as the JAX
    function; returns the per-example mean, as :func:`next_token_loss`."""
    b, t, _ = hidden.shape
    h = hidden[:, :-1]
    targets = tokens[:, 1:].long()
    n = t - 1
    pad = (-n) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    valid = (torch.arange(n + pad, device=hidden.device) < n).float()
    names = ("ln_f", "embed") if cfg.tied_embeddings else ("ln_f", "lm_head")
    w = _cast(params, cfg, names, mesh)
    total = torch.zeros((b,), dtype=torch.float32, device=hidden.device)
    for start in range(0, n + pad, chunk):
        end = start + chunk
        total = total + checkpoint(
            _chunk_xent_sum, w, h[:, start:end], targets[:, start:end],
            valid[start:end], cfg, use_reentrant=False)
    return total / n


# -- zoo contract and export --------------------------------------------------


def _to_jax_layout(value):
    """A parameter (or one of its optimizer slots) -> a host ndarray copy:
    the stacked kernels keep the JAX layout, so nothing is transposed."""
    return value.detach().to("cpu", copy=True).numpy()


def _from_jax_layout(value):
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(value))


def param_specs(cfg):
    """The JAX ``param_specs`` as a name tree: {parameter name: the mesh
    axis each of its dims is sharded over, or None}."""
    layers = {"ln1": ("pp", None), "wq": ("pp", None, "tp"),
              "wk": ("pp", None, "tp"), "wv": ("pp", None, "tp"),
              "wo": ("pp", "tp", None), "ln2": ("pp", None)}
    if cfg.moe_experts:
        layers.update({"w_router": ("pp", None, None),
                       "w_gate": ("pp", "ep", None, "tp"),
                       "w_up": ("pp", "ep", None, "tp"),
                       "w_down": ("pp", "ep", "tp", None)})
    else:
        layers.update({"w_gate": ("pp", None, "tp"),
                       "w_up": ("pp", None, "tp"),
                       "w_down": ("pp", "tp", None)})
    specs = {"embed": (None, "tp"), "ln_f": (None,)}
    specs.update({"layers." + name: spec for name, spec in layers.items()})
    if not cfg.tied_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def shard_params(params, mesh, cfg):
    """Place ``params`` (a :class:`TransformerLM` holding the whole
    arrays) on ``mesh`` by ``param_specs``: each parameter becomes this
    rank's block of it (its stage's layers, its heads and share of the
    FFN, its experts, its columns of the embedding), on the rank's
    device.  Returns the module, its parameters replaced."""
    from elasticdl_tpu_torch.parallel.spmd_trainer import place

    _check_mesh(mesh, cfg)
    return place(params, param_specs(cfg), mesh)


def next_token_targets(tokens):
    """``next_token_loss``'s shift on the global [B, T] tokens: targets
    [B, T] int64 with targets[:, t] = tokens[:, t + 1] and -1 (no target)
    at the last position.  Sharded along T with the inputs, it gives each
    rank's last position the next shard's first token."""
    tokens = torch.as_tensor(tokens).long()
    return torch.cat([tokens[:, 1:], tokens.new_full((tokens.shape[0], 1),
                                                      -1)], dim=1)


def next_token_loss_sum(logits, targets):
    """The cross entropy of ``logits`` [B, T, V] against ``targets`` [B, T]
    (``next_token_targets``' shard), summed over the positions that have a
    target."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           targets.reshape(-1), ignore_index=-1,
                           reduction="sum")


def params_from_jax(named):
    """``{"embed": ..., "layers/wq": ...}`` -> ``state_dict``.  No
    transposes: the stacked kernels keep the JAX layout."""
    return {name.replace("/", "."): _from_jax_layout(value)
            for name, value in named.items()}


def params_to_jax(module):
    return {name.replace(".", "/"): _to_jax_layout(value)
            for name, value in module.state_dict().items()}


def model_spec(vocab_size=32000, dim=512, num_heads=8, num_layers=4,
               seq_len=512, learning_rate=3e-4, mesh=None, dtype="bfloat16",
               pipeline_microbatches=0, moe_experts=0, moe_top_k=2,
               moe_aux_weight=0.01, remat=False, attention_impl="ring",
               window=0, xent_chunk=0, num_kv_heads=0):
    """Zoo entry for the flagship LM, with the JAX entry's arguments.

    ``remat`` (False | True | "dots" | "attn"), ``xent_chunk`` (> 0: the
    loss through :func:`next_token_loss_chunked`, no [B, T, V] logits)
    and ``moe_experts`` (> 0: top-``moe_top_k`` experts; training adds
    ``moe_aux_weight`` x the mean per-layer aux loss to the loss) as in
    the JAX entry; the optimizer is AdamW at ``learning_rate`` with weight
    decay 0.01 (``optax.adamw``'s).  With a ``mesh`` (``parallel/mesh.py``)
    ``init_fn`` places the parameters on it (``shard_params``) and
    ``apply_fn`` takes this rank's shard of the batch, [B/dp, T/sp], and
    runs the forward over the mesh; ``pipeline_microbatches`` > 0 with
    pp > 1 and sp = 1 runs it as a pipeline of that many microbatches
    (``forward_pipelined``, remat per stage), and warns and runs the
    plain forward otherwise, as the JAX entry does.  ``loss_fn``'s
    per-example loss shifts the labels within a sequence, so under
    sp > 1 train through ``next_token_targets``, whose shift crosses the
    shards (``parallel/spmd_trainer.py``).  The collective strategy takes
    the spec with no mesh and all-reduces the gradients over its world.
    ``generate_fn(module, prompt, max_new_tokens, temperature, seed)``
    serves generation exports.
    """
    pipelined = (pipeline_microbatches > 0 and mesh is not None
                 and mesh.shape["pp"] > 1 and mesh.shape["sp"] == 1)
    if pipeline_microbatches > 0 and not pipelined:
        # No mesh, pp=1, or sp>1 (ring attention needs the sequence
        # axis): say so instead of ignoring the knob.
        warnings.warn(
            "pipeline_microbatches ignored: pipelining requires a mesh "
            "with pp>1 and sp=1; using the scanned forward", stacklevel=2)
    if remat not in (False, True, "dots", "attn"):
        # CLI model_params arrive as strings; normalise the booleans and
        # reject typos instead of enabling remat on any truthy string.
        normalized = {"false": False, "true": True, "dots": "dots",
                      "attn": "attn"}.get(str(remat).strip().lower())
        if normalized is None:
            raise ValueError(
                "remat must be one of False, True, 'dots', 'attn'; got %r"
                % (remat,))
        remat = normalized
    cfg = TransformerConfig(
        vocab_size=vocab_size, dim=dim, num_heads=num_heads,
        num_layers=num_layers, max_seq_len=seq_len, dtype=dtype,
        moe_experts=moe_experts, moe_top_k=moe_top_k,
        moe_aux_weight=moe_aux_weight, remat=remat,
        attention_impl=attention_impl, window=window,
        num_kv_heads=num_kv_heads)
    cfg.kv_heads  # validate num_heads % num_kv_heads at spec build

    def init_fn(device, seed=0):
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        module = init_params(gen, cfg, device=device)
        return module if mesh is None else shard_params(module, mesh, cfg)

    def apply_fn(module, tokens, train):
        chunked = bool(xent_chunk and train)
        # Under the collective trainer's world the batch is split over dp
        # though the spec has no mesh: the MoE aux then takes the global
        # batch's statistics, as the JAX GSPMD step does.  Resolved here,
        # on the caller's thread, so a remat recompute sees the same mesh.
        run_mesh = mesh
        if mesh is None and cfg.moe_experts:
            run_mesh = batch_split_mesh()
        if pipelined:
            out = forward_pipelined(
                module, tokens, cfg, mesh, pipeline_microbatches,
                remat=bool(cfg.remat),
                return_aux=chunked or bool(cfg.moe_experts and train),
                return_hidden=chunked)
            return ("hidden",) + out + (module,) if chunked else out
        if chunked:
            # The memory-lean loss path: hand the final hidden states (and
            # the module, for the head inside the chunked loss) to loss_fn
            # instead of materialising [B, T, V] logits.
            hidden, aux = forward_hidden(module, tokens, cfg, mesh=run_mesh)
            return ("hidden", hidden, aux, module)
        return forward(module, tokens, cfg, mesh=run_mesh,
                       return_aux=bool(cfg.moe_experts and train))

    def loss_fn(outputs, tokens):
        if isinstance(outputs, tuple) and outputs[0] == "hidden":
            _, hidden, aux, module = outputs
            loss = next_token_loss_chunked(module, hidden, tokens, cfg,
                                           chunk=xent_chunk, mesh=mesh)
        elif isinstance(outputs, tuple):      # MoE training: (logits, aux)
            logits, aux = outputs
            loss = next_token_loss(logits, tokens)
        else:
            return next_token_loss(outputs, tokens)
        if cfg.moe_experts:
            loss = loss + cfg.moe_aux_weight * aux
        return loss

    def feed(records):
        toks = np.stack([np.asarray(r[0], dtype=np.int32) for r in records])
        # causal LM: inputs are the labels (shifted inside the loss)
        return toks, toks

    def generate_fn(module, prompt, max_new_tokens, temperature, seed):
        return generate(module, cfg, prompt, max_new_tokens,
                        temperature=temperature, seed=seed)

    spec = ModelSpec(
        name="transformer_lm", init_fn=init_fn, apply_fn=apply_fn,
        feed=feed, params_from_jax=params_from_jax,
        params_to_jax=params_to_jax, input_shape=(seq_len,),
        loss_fn=loss_fn,
        optimizer=lambda parameters: torch.optim.AdamW(
            parameters, lr=learning_rate, weight_decay=0.01),
        eval_metrics_fn=lambda: {
            "nll": metrics.Mean(lambda outputs, labels: outputs)},
        generate_fn=generate_fn, to_jax_layout=_to_jax_layout,
        from_jax_layout=_from_jax_layout)
    spec.config = cfg
    return spec


def zoo_params(cfg):
    """The ``model_params`` string that rebuilds ``cfg`` through
    :func:`model_spec` (and the JAX package's)."""
    default = TransformerConfig()
    fixed = ("mlp_ratio", "tied_embeddings", "moe_capacity_factor")
    if any(getattr(cfg, f) != getattr(default, f) for f in fixed):
        raise ValueError(
            "the zoo entry takes mlp_ratio=%d, tied embeddings and "
            "moe_capacity_factor=%g only" % (default.mlp_ratio,
                                             default.moe_capacity_factor))
    params = ("vocab_size=%d;dim=%d;num_heads=%d;num_layers=%d;seq_len=%d;"
              "dtype=%s;window=%d;num_kv_heads=%d" % (
                  cfg.vocab_size, cfg.dim, cfg.num_heads, cfg.num_layers,
                  cfg.max_seq_len, cfg.dtype, cfg.window, cfg.num_kv_heads))
    if cfg.moe_experts:
        params += ";moe_experts=%d;moe_top_k=%d;moe_aux_weight=%r" % (
            cfg.moe_experts, cfg.moe_top_k, cfg.moe_aux_weight)
    return params


def export_generate(export_dir, params, cfg, max_new_tokens, prompt_len,
                    model_name="lm", temperature=0.0, version=0):
    """Export generation itself as a servable: ``:predict`` takes prompt
    ids [B, prompt_len] int32 and answers prompt + generated ids
    [B, prompt_len + max_new_tokens] int32.

    ``prompt_len`` and ``max_new_tokens`` are fixed per export; the batch
    is free.  ``temperature`` > 0 exports a sampling servable whose input
    is the dict {"prompt": [B, Tp] int32, "seed": [] int32}; equal seeds
    reproduce exactly.  The manifest's ``"generate"`` block carries the
    three settings; the weights are the JAX package's names and layouts,
    so the ``model.npz`` loads into either package."""
    from elasticdl_tpu_torch.serving.export import export_servable

    if prompt_len + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            "prompt_len %d + max_new_tokens %d exceeds max_seq_len %d"
            % (prompt_len, max_new_tokens, cfg.max_seq_len))
    if temperature < 0:
        raise ValueError("temperature must be >= 0, got %r"
                         % (temperature,))
    prompt = np.zeros((1, prompt_len), np.int32)
    example = ({"prompt": prompt, "seed": np.int32(0)} if temperature > 0
               else prompt)
    return export_servable(
        export_dir, "transformer", zoo_params(cfg), params, example,
        model_name=model_name, version=version,
        generate={"prompt_len": int(prompt_len),
                  "max_new_tokens": int(max_new_tokens),
                  "temperature": float(temperature)})
