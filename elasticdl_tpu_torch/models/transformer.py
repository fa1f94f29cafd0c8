"""Flagship decoder-only transformer LM: serving and training
(counterpart of ``elasticdl_tpu/models/transformer.py``).

Pre-norm RMSNorm, RoPE positions, SwiGLU MLP, tied embeddings by default,
grouped-query attention (``num_kv_heads``) and sliding-window causal
attention (``window``).  Prompt attention (``forward``, ``prefill``) runs
on the flash attention kernels through ``parallel.ring_attention``, and
their backward kernels when training; decode attends one query against
the KV cache in plain PyTorch, as the JAX package does in jnp.

Parameters are stacked on a leading [num_layers] axis exactly as the JAX
pytree holds them (``layers.wq`` is [L, E, H*D]) and stay float32; every
use casts them to ``cfg.dtype``, as the JAX code does (``generate``
casts them once per call: the same values), so the gradients reach the
float32 master weights through those casts.  The JAX ``lax.scan`` over
layers is a Python loop; ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` where the JAX code wraps it in
``jax.checkpoint``, and the chunked cross-entropy checkpoints each chunk
the same way.

Not ported yet: MoE, the "dots" and "attn" remat policies, meshes and
pipelining, the ulysses attention; each raises ``NotImplementedError``
naming its ROADMAP item.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.parallel.ring_attention import ring_attention
from elasticdl_tpu_torch.utils import metrics

NEG_INF_DECODE = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if self.moe_experts:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet (ROADMAP "
                "A16)")
        if self.remat in ("dots", "attn"):
            raise NotImplementedError(
                "remat policy %r is not ported yet (ROADMAP A16); remat=True "
                "recomputes whole layers" % (self.remat,))
        if self.remat not in (False, True):
            raise ValueError("remat must be one of False, True, 'dots', "
                             "'attn'; got %r" % (self.remat,))
        if self.attention_impl != "ring":
            raise NotImplementedError(
                "attention_impl %r is not ported yet (ROADMAP A17)"
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


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "meshes (dp/tp/sp/pp sharding) are not ported yet (ROADMAP "
            "A18)")


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
        for name, shape in (("ln1", (L, E)), ("wq", (L, E, H * D)),
                            ("wk", (L, E, G * D)), ("wv", (L, E, G * D)),
                            ("wo", (L, H * D, E)), ("ln2", (L, E)),
                            ("w_gate", (L, E, F_)), ("w_up", (L, E, F_)),
                            ("w_down", (L, F_, E))):
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
    ``embed`` (and ``lm_head``) N(0, 0.02^2)."""
    module = TransformerLM(cfg, device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in ("ln_f", "layers.ln1", "layers.ln2"):
                p.fill_(1.0)
                continue
            std = (0.02 if name in ("embed", "lm_head")
                   else 1.0 / math.sqrt(p.shape[-2]))
            p.normal_(0.0, std, generator=generator)
    return module


def _cast(params, cfg, names=None):
    """{name: parameter in the compute dtype}: what each use in the JAX
    code casts (``w["wq"].astype(compute_dtype)``); only ``names`` when
    given."""
    dtype = cfg.compute_dtype
    return {name: p.to(dtype) for name, p in params.named_parameters()
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


def _layer_body(x, w, cfg, positions, return_kv=False):
    """One block over a whole sequence (weights ``w`` of one layer, in the
    compute dtype).  ``return_kv`` also returns this layer's post-RoPE,
    pre-GQA-expand (k, v) [B, T, G, D] for the KV cache."""
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
    attn = ring_attention(q, k, v, None, causal=True, window=cfg.window)
    x = x + attn.reshape(B, T, H * D) @ w["wo"]
    x = x + _ffn(_rmsnorm(x, w["ln2"]), w)
    return (x, kv) if return_kv else x


def _head(w, x, cfg):
    x = _rmsnorm(x, w["ln_f"])
    head = w["embed"].T if cfg.tied_embeddings else w["lm_head"]
    return (x @ head).float()


def _forward_hidden(w, tokens, cfg):
    x = w["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        if cfg.remat and torch.is_grad_enabled():
            # jax.checkpoint(layer): keep only the layer's input and
            # recompute the rest in the backward.
            x = checkpoint(_layer_body, x, _layer(w, i), cfg, positions,
                           use_reentrant=False)
        else:
            x = _layer_body(x, _layer(w, i), cfg, positions)
    return x


def forward_hidden(params, tokens, cfg, mesh=None):
    """tokens: [B, T] int -> (final hidden [B, T, dim] before ``ln_f``
    and the head, mean per-layer MoE aux loss), as the JAX function
    returns them; the dense FFN's aux is 0."""
    _check_mesh(mesh)
    hidden = _forward_hidden(_cast(params, cfg), tokens, cfg)
    return hidden, torch.zeros((), dtype=torch.float32,
                               device=hidden.device)


def forward(params, tokens, cfg, mesh=None):
    """tokens: [B, T] int -> logits [B, T, V] float32."""
    _check_mesh(mesh)
    w = _cast(params, cfg)
    return _head(w, _forward_hidden(w, tokens, cfg), cfg)


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
    return x + _ffn(_rmsnorm(x, w["ln2"]), w)


def _prefill(w, cfg, prompt, max_len):
    b, tp = prompt.shape
    x = w["embed"][prompt]
    positions = torch.arange(tp, device=x.device)
    ck, cv = init_kv_cache(cfg, b, max_len, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v) = _layer_body(x, _layer(w, i), cfg, positions,
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

    ``remat`` (False | True; "dots" and "attn" raise) and ``xent_chunk``
    (> 0: the loss through :func:`next_token_loss_chunked`, no [B, T, V]
    logits) as in the JAX entry; the optimizer is AdamW at
    ``learning_rate`` with weight decay 0.01 (``optax.adamw``'s).  A mesh,
    pipelining, MoE and ``attention_impl="ulysses"`` raise
    ``NotImplementedError`` naming their ROADMAP item.
    ``generate_fn(module, prompt, max_new_tokens, temperature, seed)``
    serves generation exports.
    """
    _check_mesh(mesh)
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
        return forward(module, tokens, cfg)

    def loss_fn(outputs, tokens):
        if isinstance(outputs, tuple) and outputs[0] == "hidden":
            _, hidden, _, module = outputs
            return next_token_loss_chunked(module, hidden, tokens, cfg,
                                           chunk=xent_chunk)
        return next_token_loss(outputs, tokens)

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
    if (cfg.mlp_ratio, cfg.tied_embeddings) != (default.mlp_ratio,
                                                default.tied_embeddings):
        raise ValueError(
            "the zoo entry takes mlp_ratio=%d and tied embeddings only"
            % default.mlp_ratio)
    return ("vocab_size=%d;dim=%d;num_heads=%d;num_layers=%d;seq_len=%d;"
            "dtype=%s;window=%d;num_kv_heads=%d" % (
                cfg.vocab_size, cfg.dim, cfg.num_heads, cfg.num_layers,
                cfg.max_seq_len, cfg.dtype, cfg.window, cfg.num_kv_heads))


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
