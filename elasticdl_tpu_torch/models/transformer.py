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

With a mesh (``parallel/mesh.py``: ``dp`` and ``sp``), ``forward`` and
``forward_hidden`` run one rank's shard of the batch: tokens [B/dp, T/sp]
at RoPE positions offset by the rank's place along ``sp``, attention as
ring attention (B3p; ``attention_impl="ring"``) or Ulysses (B3/B4/B5 on
the gathered sequence; ``"ulysses"``) over the ``sp`` group.  Parameters
are replicated; ``parallel/spmd_trainer.py`` reduces their gradients.
Not ported yet: ``tp``/``pp``/``ep`` sharding, MoE under ``sp`` > 1,
``forward_pipelined`` and the zoo entry's ``mesh`` argument, which
shards the parameters and feeds the forward in the JAX package (ROADMAP
A18); each raises ``NotImplementedError`` naming its ROADMAP item.  The
collective trainer trains the LM over a world with no mesh in the spec
(its gradients are all-reduced, ``worker/collective_trainer.py``).
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from elasticdl_tpu_torch.models.spec import ModelSpec
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
    """A mesh of ``dp`` and ``sp`` only; MoE only without ``sp``."""
    if mesh is None:
        return
    unported = {a: mesh.shape[a] for a in ("pp", "ep", "tp")
                if mesh.shape[a] > 1}
    if unported:
        raise NotImplementedError(
            "mesh axes %s are not ported yet (ROADMAP A18)" % unported)
    if cfg.moe_experts and mesh.shape["sp"] > 1:
        # The JAX _moe_ffn sizes each expert's capacity over the whole
        # sequence, which one shard of it cannot reproduce.
        raise NotImplementedError(
            "MoE under sequence parallelism (sp > 1) is not ported yet "
            "(ROADMAP A18)")


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


def _cast(params, cfg, names=None):
    """{name: parameter in the compute dtype}: what each use in the JAX
    code casts (``w["wq"].astype(compute_dtype)``); only ``names`` when
    given."""
    dtype = cfg.compute_dtype
    return {name: p.to(dtype) for name, p in _named(params)
            if names is None or name in names}


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


def _moe_ffn(h, w, cfg):
    """Top-k mixture-of-experts FFN (the JAX ``_moe_ffn`` with no mesh).

    Dense dispatch and combine over one-hot capacity slots per sequence:
    choice 0 has priority, and choice j's slots start after the tokens
    every earlier choice sent to that expert; a token past an expert's
    capacity falls to its other choices or to the residual.  Dispatch
    and combine run in float32, the experts in the compute dtype.
    Returns (out [B, T, E] in h's dtype, aux, stats): aux is the Switch
    load-balance loss X * sum_x frac_top1(x) * mean_prob(x), taken from
    the top-1 assignment before capacity, and stats the [2, X] stack of
    those two statistics."""
    B, T, _ = h.shape
    X = cfg.moe_experts
    K = min(cfg.moe_top_k, X)
    capacity = max(1, min(T, int(T * K * cfg.moe_capacity_factor / X) + 1))
    probs = torch.softmax((h @ w["w_router"]).float(), dim=-1)   # [B,T,X]

    top1 = F.one_hot(probs.argmax(dim=-1), X).float()
    frac_tokens = top1.mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    stats = torch.stack([frac_tokens, mean_probs])
    aux = X * (frac_tokens * mean_probs).sum()

    gate_vals, experts = _top_k(probs, K)                        # [B,T,K]
    if K > 1:
        # GShard renormalisation over the chosen experts; top-1 keeps the
        # raw gate (Switch), which keeps the router in the task loss.
        gate_vals = gate_vals / gate_vals.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)

    disp = combine = 0.0                                        # [B,T,X,C]
    offset = h.new_zeros((B, 1, X), dtype=torch.float32)
    for j in range(K):
        onehot = F.one_hot(experts[..., j], X).float()          # [B,T,X]
        pos = torch.cumsum(onehot, dim=1) - 1.0 + offset
        keep = onehot * (pos < capacity)
        # keep x one_hot(slot), without a [B, T, X, C] int64 one-hot
        slot = torch.zeros((B, T, X, capacity), dtype=torch.float32,
                           device=h.device).scatter(
            -1, pos.clamp(0, capacity - 1).long()[..., None],
            keep[..., None])
        disp = disp + slot
        combine = combine + gate_vals[..., j, None, None] * slot
        offset = offset + onehot.sum(dim=1, keepdim=True)
    xin = torch.einsum("btxc,bte->xbce", disp, h.float()).to(h.dtype)
    g = F.silu(torch.einsum("xbce,xef->xbcf", xin, w["w_gate"]))
    u = torch.einsum("xbce,xef->xbcf", xin, w["w_up"])
    y = torch.einsum("xbcf,xfe->xbce", g * u, w["w_down"])
    out = torch.einsum("btxc,xbce->bte", combine, y.float())
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


def _layer_body(x, w, cfg, positions, mesh=None, return_kv=False):
    """One block over a sequence, or this rank's shard of it with a mesh
    (weights ``w`` of one layer, in the compute dtype) -> (x, MoE aux or
    None).  ``return_kv`` also returns this layer's post-RoPE,
    pre-GQA-expand (k, v) [B, T, G, D] for the KV cache, as (x, aux,
    (k, v))."""
    B, T = x.shape[0], x.shape[1]
    H, D, G = cfg.num_heads, cfg.head_dim, cfg.kv_heads
    h = _rmsnorm(x, w["ln1"])
    q = _rope((h @ w["wq"]).reshape(B, T, H, D), positions)
    k = _rope((h @ w["wk"]).reshape(B, T, G, D), positions)
    v = (h @ w["wv"]).reshape(B, T, G, D)
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
    x = x + attn @ w["wo"]
    out, aux = _mlp(_rmsnorm(x, w["ln2"]), w, cfg)
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


def _checkpointed_layer(x, w, cfg, positions, mesh):
    """``_layer_body`` under ``torch.utils.checkpoint``: remat=True keeps
    only the layer's input, a policy also what it names.  Under a mesh the
    recompute repeats the layer's ring shifts or all-to-alls on every
    rank, in the same order."""
    policy = _REMAT_POLICIES.get(cfg.remat)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    policy) if policy is not None
                  else torch.utils.checkpoint.noop_context_fn)
    return checkpoint(_layer_body, x, w, cfg, positions, mesh,
                      use_reentrant=False, context_fn=context_fn)


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


def _forward_hidden(w, tokens, cfg, mesh=None):
    """(final hidden, mean per-layer MoE aux; 0 for the dense FFN)."""
    x = w["embed"][tokens]
    positions = _positions(tokens, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.num_layers):
        layer = _checkpointed_layer if remat else _layer_body
        x, aux = layer(x, _layer(w, i), cfg, positions, mesh)
        auxes.append(aux)
    if cfg.moe_experts:
        return x, torch.stack(auxes).mean()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_hidden(params, tokens, cfg, mesh=None):
    """tokens: [B, T] int -> (final hidden [B, T, dim] before ``ln_f``
    and the head, mean per-layer MoE aux loss), as the JAX function
    returns them; the dense FFN's aux is 0.  With a mesh, tokens and
    hidden are this rank's shards [B/dp, T/sp]."""
    _check_mesh(mesh, cfg)
    return _forward_hidden(_cast(params, cfg), tokens, cfg, mesh)


def forward(params, tokens, cfg, mesh=None, return_aux=False):
    """tokens: [B, T] int -> logits [B, T, V] float32; with
    ``return_aux`` (training an MoE), (logits, mean per-layer aux).  With
    a mesh, tokens and logits are this rank's shards [B/dp, T/sp]."""
    _check_mesh(mesh, cfg)
    w = _cast(params, cfg)
    hidden, aux = _forward_hidden(w, tokens, cfg, mesh)
    logits = _head(w, hidden, cfg)
    return (logits, aux) if return_aux else logits


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


def generate(params, cfg, prompt, max_new_tokens, temperature=0.0, seed=0):
    """Autoregressive generation: batched prefill + KV-cache decode.

    prompt: [B, Tp] int, Tp >= 1 (seed unconditional generation with a
    BOS token).  Returns int32 [B, Tp + max_new_tokens] on the params'
    device; greedy when ``temperature`` == 0 (ties take the first
    index, as in JAX), else softmax sampling at the given temperature by
    the Gumbel-max rule, as ``jax.random.categorical`` samples, from a
    ``torch.Generator`` seeded with ``seed``.  Equal seeds reproduce
    exactly on one device; the tokens cannot equal the JAX package's,
    whose random stream differs.
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
    gen = None
    if temperature:
        gen = torch.Generator(device=device).manual_seed(int(seed))

    def sample(logits):
        if not temperature:
            return logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        return (logits / temperature + gumbel).argmax(dim=-1)

    with torch.no_grad():
        w = _cast(params, cfg)
        logits, caches = _prefill(w, cfg, prompt, total)
        tokens = torch.cat(
            [prompt, torch.zeros((b, max_new_tokens), dtype=torch.long,
                                 device=device)], dim=1)
        tokens[:, tp] = sample(logits)
        for t in range(tp, total - 1):
            logits, caches = _decode_step(w, cfg, caches, t, tokens[:, t])
            tokens[:, t + 1] = sample(logits)
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


def next_token_loss_chunked(params, hidden, tokens, cfg, chunk=512):
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
    w = _cast(params, cfg, names)
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
    return torch.from_numpy(np.array(value))


def param_specs(cfg):
    """The JAX ``param_specs`` as a name tree: {parameter name: the mesh
    axis each of its dims is sharded over, or None}.  Only the replicated
    layout (no ``tp``, ``pp`` or ``ep``) is ported (``shard_params``)."""
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
    """Place ``params`` (a :class:`TransformerLM`) on ``mesh`` by
    ``param_specs``: replicated over ``dp`` and ``sp``, which is every
    parameter on every rank, moved to the rank's device.  A mesh whose
    ``tp``, ``pp`` or ``ep`` would shard a dimension raises (A18)."""
    from elasticdl_tpu_torch.parallel.spmd_trainer import replicate

    _check_mesh(mesh, cfg)
    return replicate(params, param_specs(cfg), mesh)


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
    decay 0.01 (``optax.adamw``'s).  A ``mesh`` (which in the JAX entry
    shards the parameters and feeds the forward) and pipelining raise
    ``NotImplementedError`` naming their ROADMAP item (A18).  The
    collective strategy needs neither: its trainer takes the spec as it
    is and all-reduces the gradients over the world.
    ``generate_fn(module, prompt, max_new_tokens, temperature, seed)``
    serves generation exports.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the zoo entry's mesh (parameters sharded by it, the forward "
            "over it) is not ported yet (ROADMAP A18); train over a dp/sp "
            "mesh with parallel.spmd_trainer.SPMDTrainer, or over a "
            "collective world with no mesh in the spec")
    if pipeline_microbatches:
        raise NotImplementedError(
            "pipelining is not ported yet (ROADMAP A18)")
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
        return init_params(gen, cfg, device=device)

    def apply_fn(module, tokens, train):
        if xent_chunk and train:
            # The memory-lean loss path: hand the final hidden states (and
            # the module, for the head inside the chunked loss) to loss_fn
            # instead of materialising [B, T, V] logits.
            hidden, aux = forward_hidden(module, tokens, cfg)
            return ("hidden", hidden, aux, module)
        return forward(module, tokens, cfg,
                       return_aux=bool(cfg.moe_experts and train))

    def loss_fn(outputs, tokens):
        if isinstance(outputs, tuple) and outputs[0] == "hidden":
            _, hidden, aux, module = outputs
            loss = next_token_loss_chunked(module, hidden, tokens, cfg,
                                           chunk=xent_chunk)
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
