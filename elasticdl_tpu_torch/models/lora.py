"""LoRA fine-tuning for the flagship LM (counterpart of
``elasticdl_tpu/models/lora.py``).

Low-Rank Adaptation (Hu et al. 2021, arXiv:2106.09685): the pretrained
weights W stay frozen and each target matrix trains a rank-r update,
W + (alpha / r) A @ B.  As in the JAX package:

 - **Merge at forward**: the adapted weights W_eff = W + scale A @ B (one
   [L, in, r] x [L, r, out] einsum over the stacked-layer axis) go into
   the unchanged transformer forward, so every variant of it (GQA, a
   window, MoE, remat, the chunked loss) runs under LoRA with no adapter
   code inside the layer.  Autograd reaches A and B through W_eff.
 - **Frozen base**: the base parameters have ``requires_grad=False`` and
   are in no optimizer group, so they get no gradient and no optimizer
   state (the JAX package's ``optax.set_to_zero`` leaves, whose moments
   are never allocated).  The adapters train with AdamW (weight decay
   0.01), the norm scales with ``train_norms`` with Adam (no decay): the
   groups of the JAX ``optax.multi_transform``, whose state names the
   trainer's checkpoints keep (each group's ``jax_prefix``).
 - **Merged export**: :func:`merged_params` folds the adapters into a
   plain :class:`~elasticdl_tpu_torch.models.transformer.TransformerLM`,
   which ``transformer.export_generate`` and the server take as they take
   any other: serving needs no LoRA code.

``base_export`` names an export of the base LM (``model.npz`` in the JAX
package's names, as ``transformer.export_generate`` writes it) to adapt:
pretrain, export, adapt, serve merged.  Not ported yet: LoRA under a mesh
(ROADMAP A18) and an int8 base export (A11).
"""

import torch

from elasticdl_tpu_torch.models import transformer as tfm
from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.serving.export import load_export
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")
_NORMS = ("base.layers.ln1", "base.layers.ln2", "base.ln_f")
# The inner states of the JAX spec's optax.multi_transform, by label.
_GROUP_PREFIX = "inner_states/%s/inner_state/"


def _target_shapes(base_layers, targets):
    """{target: (in_dim, out_dim)} for each adapted [L, in, out] W of
    ``base_layers`` ({name: tensor})."""
    shapes = {}
    for t in targets:
        if t not in base_layers:
            raise ValueError(
                "unknown LoRA target %r; this architecture has: %s"
                % (t, ", ".join(sorted(base_layers))))
        w = base_layers[t]
        if w.dim() != 3:
            raise ValueError(
                "LoRA target %r has rank-%d weights; only stacked "
                "[L, in, out] matrices are adaptable" % (t, w.dim()))
        shapes[t] = (w.shape[1], w.shape[2])
    return shapes


def _layers(base):
    return dict(base.layers.named_parameters())


def init_lora(generator, base_layers, targets, rank, device=None):
    """A module holding ``<target>.A`` ~ N(0, 1/r) and ``<target>.B`` = 0
    per target, drawn from ``generator`` in sorted target order: the delta
    starts at exactly zero, so step 0 is the base model."""
    L = next(iter(base_layers.values())).shape[0]
    lora = torch.nn.Module()
    for t, (d_in, d_out) in sorted(
            _target_shapes(base_layers, targets).items()):
        adapter = torch.nn.Module()
        a = torch.empty((L, d_in, rank), dtype=torch.float32, device=device)
        adapter.A = torch.nn.Parameter(
            a.normal_(0.0, rank ** -0.5, generator=generator))
        adapter.B = torch.nn.Parameter(torch.zeros(
            (L, rank, d_out), dtype=torch.float32, device=device))
        setattr(lora, t, adapter)
    return lora


def merge_layers(base_layers, lora, scaling):
    """``base_layers`` ({name: tensor}) with W_eff on the adapted
    targets."""
    merged = dict(base_layers)
    for t, adapter in lora.named_children():
        delta = torch.einsum("lir,lro->lio", adapter.A, adapter.B)
        merged[t] = base_layers[t] + scaling * delta.to(base_layers[t].dtype)
    return merged


class LoRALM(torch.nn.Module):
    """``base`` (a frozen :class:`TransformerLM`) and ``lora`` (the
    adapters), named as the JAX spec's {"base": ..., "lora": ...} tree:
    ``base.layers.wq``, ``lora.wq.A``."""

    def __init__(self, base, lora):
        super().__init__()
        self.base = base
        self.lora = lora


def _merged_weights(module, scaling):
    """{TransformerLM name: tensor} with W_eff on the adapted targets: the
    weights the transformer's functions take in place of a module."""
    layers = merge_layers(_layers(module.base), module.lora, scaling)
    weights = {name: p for name, p in module.base.named_parameters()
               if not name.startswith("layers.")}
    weights.update({"layers." + name: w for name, w in layers.items()})
    return weights


def merged_params(module, scaling):
    """Fold the adapters of a :class:`LoRALM` into a plain
    :class:`TransformerLM` on the same device (for export and serving).
    ``scaling`` is the spec's alpha / rank (``spec.lora["scaling"]``),
    required: a default would mis-scale any other rank or alpha."""
    base = module.base
    merged = tfm.TransformerLM(base.cfg, device=base.embed.device)
    with torch.no_grad():
        merged.load_state_dict(_merged_weights(module, scaling))
    return merged


def _load_base_export(base_export, base):
    """Load an export's weights into ``base`` by their JAX names."""
    dense, _ = load_export(base_export)
    names = tfm.params_to_jax(base)
    missing = sorted(set(names) - set(dense))
    if missing:
        raise ValueError(
            "base export %s lacks %d parameters (e.g. %s) — wrong "
            "architecture kwargs?" % (base_export, len(missing),
                                      missing[:3]))
    base.load_state_dict(tfm.params_from_jax(
        {name: dense[name] for name in names}))


def model_spec(rank=8, alpha=16.0, lora_targets=None, base_export="",
               learning_rate=1e-4, train_norms=False, **lm_kwargs):
    """Zoo entry: the flagship LM with LoRA adapters, with the JAX
    entry's arguments.

    ``lora_targets``: comma-joined target names (default the four
    attention projections; w_gate, w_up and w_down of a dense FFN too;
    an MoE's [L, X, in, out] experts are refused).  ``base_export``: an
    export of the base LM to adapt (a fresh random base otherwise).
    ``train_norms``: also train the norm scales, without weight decay.
    The other arguments go to ``transformer.model_spec``.
    """
    lm_kwargs.setdefault("learning_rate", learning_rate)
    base_spec = tfm.model_spec(**lm_kwargs)
    cfg = base_spec.config
    if isinstance(lora_targets, str):
        targets = tuple(
            t.strip() for t in lora_targets.split(",") if t.strip())
    else:
        targets = tuple(lora_targets or DEFAULT_TARGETS)
    rank = int(rank)
    scaling = float(alpha) / rank
    train_norms = str(train_norms).strip().lower() in ("true", "1")

    def init_fn(device, seed=0):
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        base = tfm.init_params(gen, cfg, device=device)
        if base_export:
            _load_base_export(base_export, base)
        lora = init_lora(gen, _layers(base), targets, rank, device=device)
        for name, p in base.named_parameters():
            p.requires_grad_(train_norms and "base." + name in _NORMS)
        n_adapter = sum(p.numel() for p in lora.parameters())
        n_base = sum(p.numel() for p in base.parameters())
        logger.info(
            "LoRA r=%d over %s: %d trainable / %d frozen params "
            "(%.2f%%)", rank, ",".join(sorted(targets)), n_adapter,
            n_base, 100.0 * n_adapter / max(1, n_base))
        return LoRALM(base, lora)

    def apply_fn(module, tokens, train):
        return base_spec.apply_fn(_merged_weights(module, scaling), tokens,
                                  train)

    def optimizer(named_parameters):
        adapters, norms = [], []
        for name, p in named_parameters:
            if name.startswith("lora."):
                adapters.append(p)
            elif train_norms and name in _NORMS:
                norms.append(p)
        return torch.optim.AdamW([
            # Decay regularises the delta, the standard LoRA choice.
            {"params": adapters, "weight_decay": 0.01,
             "jax_prefix": _GROUP_PREFIX % "train"},
            # Norm scales without decay, which would pull the RMSNorm
            # scales (1 at init) toward 0.
            {"params": norms, "weight_decay": 0.0,
             "jax_prefix": _GROUP_PREFIX % "train_norm"},
        ], lr=lm_kwargs["learning_rate"])

    spec = ModelSpec(
        name="transformer_lm_lora", init_fn=init_fn, apply_fn=apply_fn,
        feed=base_spec.feed, params_from_jax=tfm.params_from_jax,
        params_to_jax=tfm.params_to_jax, input_shape=base_spec.input_shape,
        loss_fn=base_spec.loss_fn, optimizer=optimizer,
        eval_metrics_fn=base_spec.eval_metrics_fn,
        to_jax_layout=base_spec.to_jax_layout,
        from_jax_layout=base_spec.from_jax_layout)
    spec.config = cfg
    spec.lora = {"rank": rank, "scaling": scaling, "targets": targets}
    return spec
