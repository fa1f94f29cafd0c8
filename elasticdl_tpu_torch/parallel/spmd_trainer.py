"""SPMD trainer over a mesh of dp, pp, ep, tp and sp (counterpart of
``elasticdl_tpu/parallel/spmd_trainer.py``).

The JAX trainer is one jitted step over global arrays whose parameters,
optimizer state and activations carry shardings; GSPMD inserts the
collectives.  Here the step runs in every rank of the mesh, each on its
own shard of the batch and of the parameters: ``put_batch`` takes the
global host batch (the same on every rank) and keeps this rank's rows
(``dp``) and positions (``sp``), by ``batch_spec``, and ``place`` keeps
this rank's block of each parameter, by its spec (a name tree of the JAX
PartitionSpecs, e.g. ``transformer.param_specs``).  The optimizer state
follows its parameter's block, as the JAX trainer's follows its
parameter's sharding.

The loss is the global mean over every term of the batch: ``loss_fn``
returns this rank's sum and term count, each rank divides its sum by the
count summed over the whole mesh, and the objective is the sum of those
shares over the ranks.  A rank of the ``pp``, ``ep`` or ``tp`` axes holds
the same data shard as its peers along them and computes the same loss,
so the count holds that shard once per peer and the shares still sum to
the mean.  The collectives of the forward are the exact transposes
GSPMD gives (``parallel/transport.py``), so a rank's autograd gives the
gradient of that objective with respect to its own copy of each block;
a parameter's gradient is then the sum over the ranks that hold the same
block, the mesh axes its spec does not name (one process group per set
of such axes, ``parallel/mesh.py``): over ``dp`` the mean of the
dp-local means, over ``sp`` their sum, over ``tp`` the partial gradients
a replicated weight (a norm scale) gets from each rank's heads.  A causal
LM's labels are shifted on the global tokens before the batch is sliced
(``models.transformer.next_token_targets``), so a shard's last position
predicts the next shard's first token.

Checkpoints hold the parameters and the optimizer state in the JAX
trainer's names (``opt/0/mu/...``) and full shapes: every block is
gathered (each rank gathers its own over the axes its spec names, and
rank 0 writes through the port's ``CheckpointSaver``).  Every rank
restores the same file, whatever mesh wrote it, and keeps its own block,
so a restore re-shards onto the current mesh.
"""

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.parallel import transport
from elasticdl_tpu_torch.parallel.mesh import AXES
from elasticdl_tpu_torch.worker.collective_trainer import (
    _opt_state_from_jax,
    _opt_state_to_jax,
)


def block(x, spec, mesh):
    """This rank's block of the whole array ``x`` (a tensor) by ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n, i = mesh.shape[axis], mesh.coords[axis]
        if x.shape[dim] % n:
            if axis == "pp" and dim == 0:
                raise ValueError(
                    "stacked-layer dim %d not divisible by %d pipeline "
                    "stages" % (x.shape[dim], n))
            raise ValueError("dim %d of size %d does not split over %s=%d"
                             % (dim, x.shape[dim], axis, n))
        x = x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)
    return x


def gather_block(x, spec, mesh):
    """The whole array from every rank's block ``x`` by ``spec``: a
    collective over the axes the spec names, which every rank calls."""
    axes = mesh.live([a for a in spec if a is not None])
    if not axes:
        return x
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    blocks = transport.gather_along(x[None], mesh.group(axes), 0)
    sizes = [mesh.shape[a] for a in axes]
    shape = [n * (mesh.shape[a] if a in axes else 1)
             for n, a in zip(x.shape, spec)]
    full = x.new_empty(shape)
    for j, piece in enumerate(blocks):
        at = dict(zip(axes, np.unravel_index(j, sizes)))
        view = full
        for dim, axis in enumerate(spec):
            if axis in at:
                view = view.narrow(dim, int(at[axis]) * x.shape[dim],
                                   x.shape[dim])
        view.copy_(piece)
    return full


def place(module, param_specs, mesh):
    """Place ``module``'s parameters on ``mesh`` by ``param_specs`` ({name:
    the mesh axis of each dim, or None}; None: every parameter
    replicated): each becomes this rank's block of it, on the rank's
    device.  A module already placed on ``mesh`` is returned as it is."""
    if param_specs is not None:
        names = {name for name, _ in module.named_parameters()}
        if names != set(param_specs):
            raise ValueError("param_specs name %s, the module has %s"
                             % (sorted(param_specs), sorted(names)))
    if getattr(module, "placed_on", None) is mesh:
        return module
    module = module.to(mesh.device)
    if param_specs is not None:
        for name, p in list(module.named_parameters()):
            mine = block(p.detach(), param_specs[name], mesh)
            if mine.shape == p.shape:
                continue
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf, torch.nn.Parameter(
                mine.contiguous().clone(), requires_grad=p.requires_grad))
    module.placed_on = mesh
    return module


def _host(t):
    return t.detach().to("cpu", copy=True).numpy()


def _from_host(a):
    return torch.from_numpy(np.array(a))


class SPMDTrainer:
    """``init_fn(device, seed)`` builds the module (every rank the same
    parameters, from ``rng_seed``; the whole arrays, or already placed on
    the mesh); ``loss_fn(module, batch)`` returns (loss summed over this
    rank's shard, the number of terms summed), f32 scalars;
    ``optimizer(named_parameters)`` builds the torch optimizer;
    ``param_specs`` names each parameter's sharded axes (the JAX
    PartitionSpecs as a name tree, e.g. ``transformer.param_specs``; None:
    replicated); ``batch_spec`` names the mesh axis of each batch
    dimension."""

    def __init__(self, mesh, init_fn, loss_fn, optimizer, param_specs=None,
                 batch_spec=("dp", "sp"), rng_seed=0):
        self.mesh = mesh
        self._loss_fn = loss_fn
        self._batch_spec = batch_spec
        self.module = place(init_fn(mesh.device, rng_seed), param_specs,
                            mesh)
        self._specs = {
            name: (param_specs[name] if param_specs is not None
                   else (None,) * p.dim())
            for name, p in self.module.named_parameters()}
        # Each gradient is summed over the axes its spec does not name:
        # one flat reduction per group, in one fixed order on every rank.
        by_axes = {}
        for name, p in self.module.named_parameters():
            if not p.requires_grad:
                continue
            named = set(self._specs[name])
            axes = mesh.live([a for a in AXES if a not in named])
            if axes:
                by_axes.setdefault(axes, []).append(p)
        self._grad_groups = [(mesh.group(axes), params) for axes, params
                             in sorted(by_axes.items())]
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
        """Forward and backward on the global batch, each block's gradient
        summed over the ranks that hold it into its ``.grad``; returns
        the global mean loss (a device scalar, the same on every rank)."""
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        share = self._global_mean(batch)
        share.backward()
        for group, params in self._grad_groups:
            transport.all_reduce_grads_(params, group)
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

    def _slot_specs(self, keys):
        """{optimizer slot name: its parameter's spec} for the slots that
        end with a parameter's JAX name (the longest such name)."""
        specs = {jax_name(name): spec for name, spec in self._specs.items()}
        out = {}
        for key in keys:
            owners = [n for n in specs if key.endswith("/" + n)]
            if owners:
                out[key] = specs[max(owners, key=len)]
        return out

    def full_state(self):
        """{JAX name: whole host array} of the parameters and, under
        ``opt/``, the optimizer state: every block gathered.  A
        collective: every rank calls it."""
        payload = {}
        for name, p in self.module.named_parameters():
            payload[jax_name(name)] = _host(
                gather_block(p.detach(), self._specs[name], self.mesh))
        opt = _opt_state_to_jax(self.optimizer, self._named_params(),
                                lambda t: t.detach())
        slot_specs = self._slot_specs(opt)
        for key, value in opt.items():
            if key in slot_specs:
                value = _host(gather_block(value, slot_specs[key],
                                           self.mesh))
            payload["opt/" + key] = value
        return payload

    def save_checkpoint(self, saver):
        """Every block gathered, rank 0 writes the parameters and the
        optimizer state (``opt/``) as version ``self.version``; every rank
        returns once it is written."""
        payload = self.full_state()
        if dist.get_rank(self.mesh.group()) == 0:
            saver.save(self.version, dense=payload)
        dist.barrier(group=self.mesh.group())

    def restore_checkpoint(self, saver):
        """Load the latest version, this rank's block of each array,
        whatever mesh wrote it; returns the version.  Without optimizer
        state in the checkpoint the optimizer starts afresh."""
        dense, version = saver.load()
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                whole = _from_host(dense[jax_name(name)])
                p.copy_(block(whole, self._specs[name], self.mesh))
        opt_named = {k[len("opt/"):]: v for k, v in dense.items()
                     if k.startswith("opt/")}
        slot_specs = self._slot_specs(opt_named)
        for key, spec in slot_specs.items():
            opt_named[key] = block(_from_host(opt_named[key]), spec,
                                   self.mesh)
        self.optimizer = self._new_optimizer()
        if opt_named:
            _opt_state_from_jax(self.optimizer, self._named_params(),
                                opt_named, _from_host)
        self.version = version
        return version
