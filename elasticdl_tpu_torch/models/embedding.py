"""User-facing embedding layers for zoo models (counterpart of
``elasticdl_tpu/models/embedding.py``).

The reference exposes `elasticdl.layers.Embedding` + EmbeddingColumn whose
weights live on the PS (embedding.py:20-162, feature_column.py:25-221,
with the lookup machinery in embedding_delegate.py:26-310).  Here the
same capability is two small pieces that compose with the trainer's
``emb__/idx__`` convention:

 - ``Embedding``: declares a PS table and, inside the step, turns the
   trainer-provided rows + indices into dense [B, F, dim] (or combined
   [B, dim]) activations with torch operations, so the gradient reaches
   the rows.  Dense ids and ragged (padded + mask) inputs both work;
   combiners match the reference (sum / mean / sqrtn).
 - ``embedding_feature_column``: the feature-column-style helper that
   binds a feature name to an Embedding for tabular feeds.

Whether the table actually lives on the PS or on the device is decided
by models/model_handler.py's placement plan — the layer is agnostic.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.preprocessing.layers import SparseEmbedding


class Embedding:
    def __init__(self, name, dim, initializer="uniform", combiner=None):
        """combiner None -> [B, F, dim] sequence output;
        'sum'|'mean'|'sqrtn' -> [B, dim] pooled output."""
        self.name = name
        self.dim = dim
        self.initializer = initializer
        self.combiner = combiner
        self._combine = SparseEmbedding(combiner) if combiner else None

    @property
    def info(self):
        """ps_embedding_infos entry for the ModelSpec."""
        return {"name": self.name, "dim": self.dim,
                "initializer": self.initializer}

    # -- feed side ----------------------------------------------------------

    def collect_ids(self, features, ids, mask=None):
        """Register this layer's ids into a feed's feature dict."""
        features.setdefault("__ids__", {})[self.name] = np.asarray(
            ids, np.int64
        )
        if mask is not None:
            features["mask__" + self.name] = np.asarray(mask, np.float32)
        return features

    # -- device side --------------------------------------------------------

    def __call__(self, feats):
        """Inside apply_fn: gather this layer's activations."""
        rows = torch.as_tensor(feats["emb__" + self.name])  # [U|V, dim]
        idx = torch.as_tensor(feats["idx__" + self.name],
                              device=rows.device).long()    # [B, F]
        gathered = rows[idx]                                # [B, F, dim]
        if self._combine is None:
            return gathered
        mask = feats.get("mask__" + self.name)
        if mask is None:
            mask = torch.ones(idx.shape, dtype=rows.dtype,
                              device=rows.device)
        return self._combine(gathered, mask)


def embedding_feature_column(feature_name, vocab_size, dim,
                             combiner="mean"):
    """Feature-column-style helper: returns an Embedding whose table is
    named after the feature (reference EmbeddingColumn parity)."""
    layer = Embedding("col__" + feature_name, dim, combiner=combiner)
    layer.vocab_size = vocab_size
    return layer
