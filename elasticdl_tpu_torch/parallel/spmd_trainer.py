"""SPMD trainer over a mesh of ``dp`` and ``sp`` (counterpart of
``elasticdl_tpu/parallel/spmd_trainer.py``).

The JAX trainer is one jitted step over global arrays whose parameters,
optimizer state and activations carry shardings; GSPMD inserts the
collectives.  Here the step runs in every rank of the mesh, each on its
own shard of the batch: ``put_batch`` takes the global host batch (the
same on every rank) and keeps this rank's rows (``dp``) and positions
(``sp``), by ``batch_spec``.  Parameters and optimizer state are
replicated, which is the JAX trainer's layout for a mesh of ``dp`` and
``sp`` (``tp``, ``pp`` and ``ep`` are ROADMAP A18).

The loss is the global mean over every term of the batch: ``loss_fn``
returns this rank's sum and term count, each rank divides its sum by the
global count, and the gradients of those shares are summed over the whole
mesh, which over ``dp`` is the mean of the dp-local means and over ``sp``
their sum: what GSPMD computes for the JAX trainer.  A causal LM's labels
are shifted on the global tokens before the batch is sliced
(``models.transformer.next_token_targets``), so a shard's last position
predicts the next shard's first token.

Checkpoints hold the parameters and the optimizer state in the JAX
trainer's names (``opt/0/mu/...``), written by rank 0 through the port's
``CheckpointSaver``; every rank restores the same file, whatever mesh
wrote it, so a restore re-shards onto the current mesh.
"""

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.parallel import transport
from elasticdl_tpu_torch.worker.collective_trainer import (
    _opt_state_from_jax,
    _opt_state_to_jax,
)


def replicate(module, param_specs, mesh):
    """Place ``module``'s parameters on ``mesh`` by ``param_specs`` ({name:
    the mesh axis of each dim, or None}; None: no check): replicated on
    every rank, on the rank's device.  A spec that shards a dimension over
    an axis larger than 1 raises (ROADMAP A18)."""
    if param_specs is not None:
        names = {name for name, _ in module.named_parameters()}
        if names != set(param_specs):
            raise ValueError("param_specs name %s, the module has %s"
                             % (sorted(param_specs), sorted(names)))
        sharded = sorted(name for name, spec in param_specs.items()
                         if any(a is not None and mesh.shape[a] > 1
                                for a in spec))
        if sharded:
            raise NotImplementedError(
                "sharded parameters %s are not ported yet (ROADMAP A18)"
                % sharded)
    return module.to(mesh.device)


def _host(t):
    return t.detach().to("cpu", copy=True).numpy()


def _from_host(a):
    return torch.from_numpy(np.array(a))


class SPMDTrainer:
    """``init_fn(device, seed)`` builds the module (every rank the same
    parameters, from ``rng_seed``); ``loss_fn(module, batch)`` returns
    (loss summed over this rank's shard, the number of terms summed), f32
    scalars; ``optimizer(named_parameters)`` builds the torch optimizer;
    ``param_specs`` names each parameter's sharded axes (the JAX
    PartitionSpecs as a name tree, e.g. ``transformer.param_specs``), of
    which only the replicated layout is ported; ``batch_spec`` names the
    mesh axis of each batch dimension."""

    def __init__(self, mesh, init_fn, loss_fn, optimizer, param_specs=None,
                 batch_spec=("dp", "sp"), rng_seed=0):
        self.mesh = mesh
        self._loss_fn = loss_fn
        self._batch_spec = batch_spec
        self.module = replicate(init_fn(mesh.device, rng_seed), param_specs,
                                mesh)
        self._new_optimizer = lambda: optimizer(self.module.named_parameters())
        self.optimizer = self._new_optimizer()
        self.version = 0

    # -- batches and steps --------------------------------------------------

    def _shard(self, x):
        """This rank's block of one global batch leaf, on its device."""
        x = torch.as_tensor(x)
        for dim, axis in enumerate(self._batch_spec):
            if axis is None:
                continue
            n, i = self.mesh.shape[axis], self.mesh.coords[axis]
            if x.shape[dim] % n:
                raise ValueError(
                    "batch dim %d of size %d does not split over %s=%d"
                    % (dim, x.shape[dim], axis, n))
            x = x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)
        return x.to(self.mesh.device)

    def put_batch(self, batch):
        """The global host batch (a tuple of arrays, the same on every
        rank) -> this rank's shard of each, on its device."""
        return tuple(self._shard(x) for x in batch)

    def _global_mean(self, batch):
        """This rank's share of the global mean loss (differentiable)."""
        loss_sum, count = self._loss_fn(self.module, self.put_batch(batch))
        total = torch.as_tensor(count, dtype=torch.float32,
                                device=self.mesh.device).reshape(1).clone()
        transport.all_reduce_sum_([total], self.mesh.group())
        return loss_sum / total[0]

    def _reduced(self, share):
        value = share.detach().reshape(1).clone()
        transport.all_reduce_sum_([value], self.mesh.group())
        return value[0]

    def compute_gradients(self, batch):
        """Forward and backward on the global batch, the gradients summed
        over the mesh into every replica's ``.grad``; returns the global
        mean loss (a device scalar, the same on every rank)."""
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        share = self._global_mean(batch)
        share.backward()
        transport.all_reduce_grads_(self.module.parameters(),
                                    self.mesh.group())
        return self._reduced(share)

    def train_step(self, batch):
        """One step on the global batch; returns the global mean loss."""
        loss = self.compute_gradients(batch)
        self.optimizer.step()
        self.version += 1
        return loss

    def eval_loss(self, batch):
        self.module.eval()
        with torch.no_grad():
            return self._reduced(self._global_mean(batch))

    # -- checkpoints --------------------------------------------------------

    def _named_params(self):
        return [(jax_name(name), p)
                for name, p in self.module.named_parameters()]

    def save_checkpoint(self, saver):
        """Rank 0 writes the parameters and the optimizer state (``opt/``)
        as version ``self.version``; every rank returns once it is
        written."""
        if dist.get_rank(self.mesh.group()) == 0:
            payload = {name: _host(p) for name, p in self._named_params()}
            payload.update({
                "opt/" + k: v for k, v in _opt_state_to_jax(
                    self.optimizer, self._named_params(), _host).items()})
            saver.save(self.version, dense=payload)
        dist.barrier(group=self.mesh.group())

    def restore_checkpoint(self, saver):
        """Load the latest version into this rank's replica, whatever mesh
        wrote it; returns the version.  Without optimizer state in the
        checkpoint the optimizer starts afresh."""
        dense, version = saver.load()
        with torch.no_grad():
            for name, p in self._named_params():
                p.copy_(_from_host(dense[name]))
        opt_named = {k[len("opt/"):]: v for k, v in dense.items()
                     if k.startswith("opt/")}
        self.optimizer = self._new_optimizer()
        if opt_named:
            _opt_state_from_jax(self.optimizer, self._named_params(),
                                opt_named, _from_host)
        self.version = version
        return version
