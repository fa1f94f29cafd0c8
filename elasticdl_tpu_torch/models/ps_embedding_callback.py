"""PS embedding lookups inside the step, a ``torch.autograd.Function``
(counterpart of ``elasticdl_tpu/models/ps_embedding_callback.py``).

The reference routes embedding lookups through ``tf.py_function`` and
re-wires the tape so sparse gradients flow back to the parameter server
(elasticdl/python/elasticdl/layers/embedding.py +
embedding_delegate.py:232-281).  The framework's default design avoids
the problem (the emb__/idx__ convention: the trainer pulls rows on the
host and feeds them as leaf tensors of the step).  This module is the
direct analog of the reference mechanism, for when the lookup must live
inside the model's forward:

 - forward: pulls rows from the PS through the port's ``ps_client``
   (``[B] ids -> [B, dim]`` float32, on the ids' device);
 - backward: pushes the sparse gradient straight to the PS (the
   async-SGD push; duplicate ids merge server-side) and returns no
   gradient for the integer ids.

**The handle: the tape needs it.**  Autograd runs a Function's backward
only when one of its inputs requires grad, and PS rows depend on no
local parameter: the ids are integers.  So, as in the JAX package, the
table is represented among the model's parameters by a scalar
``handle`` (``PSEmbedding.handle``: a float32 zero that requires grad;
its gradient is always 0, so an optimizer leaves it be), and
``lookup(ids, handle)`` threads it through, so the loss's gradient must
flow through the lookup and the backward push fires.  (JAX needs it for
the same reason: reverse AD evaluates a VJP only on paths that reach a
differentiated input.)

Trade-offs against the default design: a host round trip inside every
step (the reference pays the same through py_function) and
push-on-backward semantics (the PS applies the update at once, async
mode; in sync mode pair it with grads_to_wait as usual).  Use the
default host-pulled design unless the table cannot be staged per batch.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, handle, embedding):
        del handle  # differentiation hook only (see module doc)
        ctx.embedding = embedding
        ctx.save_for_backward(ids)
        return embedding.pull(ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        ctx.embedding.push(ids, grad)
        # The ids take no gradient; the handle's is zero (the
        # "weights" live on the PS).
        return None, grad.new_zeros(()), None


class PSEmbedding:
    """One PS-backed table, usable inside a differentiated forward.

    ``embedding(ids, handle)`` is differentiable: its backward pushes the
    sparse gradient to the PS.  ``version_fn`` supplies the gradient
    version for staleness handling (defaults to 0 — pure async)."""

    def __init__(self, ps_client, table, dim, learning_rate=0.0,
                 version_fn=None):
        self._ps = ps_client
        self._table = table
        self._dim = int(dim)
        self._learning_rate = learning_rate
        self._version_fn = version_fn or (lambda: 0)

    def pull(self, ids):
        """The rows of ``ids`` (any shape), as ``ids.shape + (dim,)``
        float32 on the ids' device."""
        host = ids.detach().cpu().numpy().astype(np.int64)
        rows = self._ps.pull_embedding_vectors(self._table, host.ravel())
        rows = np.asarray(rows, np.float32).reshape(
            host.shape + (self._dim,))
        return torch.from_numpy(rows).to(ids.device)

    def push(self, ids, grads):
        """Push ``grads`` (``ids.shape + (dim,)``) for ``ids`` to the PS."""
        version = int(self._version_fn())
        accepted, server_version = self._ps.push_gradients(
            {},
            {self._table: (
                grads.detach().float().cpu().numpy().reshape(-1, self._dim),
                ids.detach().cpu().numpy().astype(np.int64).ravel(),
            )},
            version=version,
            learning_rate=self._learning_rate,
        )
        if not accepted:
            # Sync-mode staleness reject: the minibatch's table update
            # is DROPPED (the dense path re-pulls and retries; a
            # backward-pass push has no retry point) — at least say so
            # instead of silently not learning.
            logger.warning(
                "PS rejected embedding push for %r (grad version %d vs "
                "server %s); table update dropped",
                self._table, version, server_version)

    @property
    def handle(self):
        """Put this among the parameters and pass it to ``__call__``: it
        is what routes the loss's gradient through the lookup so the
        backward push fires."""
        return torch.zeros((), requires_grad=True)

    def __call__(self, ids, handle):
        return _Lookup.apply(torch.as_tensor(ids), handle, self)
