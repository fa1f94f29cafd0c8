"""Collective trainer (counterpart of
``elasticdl_tpu/worker/collective_trainer.py``).

One process, one device; alone (no mesh, the trainer that the JAX
package's ``bench.py`` and its trainer tests drive) or as one rank of a
world: a data-parallel one (a ``parallel/mesh.data_mesh``, the managed
elastic collective path) or a mesh with other axes too
(``parallel/distributed.elastic_mesh_builder``).  What it keeps of the
JAX trainer:

 - padding to a static batch with a loss mask (``_masked_mean``,
   ``_pad_batch``), so a partial minibatch trains on the same shapes as
   a full one; features and labels may be one array or a tree (dicts,
   lists, tuples) of them, every leaf padded alike;
 - gradient accumulation (``accum_steps``): the minibatch is split into
   ``accum`` microbatches, their gradients are summed and divided by
   ``accum``, as the JAX trainer's ``lax.scan`` does; here the scan is a
   Python loop and the sum is autograd's accumulation into ``.grad``;
 - the lazy loss: ``train_minibatch`` returns a device scalar and never
   synchronises;
 - checkpoints through ``utils.checkpoint.CheckpointSaver`` in the JAX
   package's names and layouts, optimizer state included (SGD momentum
   as ``opt/0/trace/<param>``, Adam and AdamW as ``opt/0/count``,
   ``opt/0/mu/<param>``, ``opt/0/nu/<param>``: what
   ``flatten_with_names`` gives optax's states), written on one
   background thread, so a checkpoint moves between the packages in both
   directions.  Each slot takes its parameter's layout map from the
   spec (``to_jax_layout``, ``from_jax_layout``).  A parameter group
   with a ``"jax_prefix"`` stands for one inner state of an optax
   ``multi_transform`` (``models/lora.py``): its names take that prefix
   (``inner_states/train/inner_state/``) and it has a count of its own;
   parameters in no group (a frozen base) have no state;
 - the spec's ``optimizer`` is called with the module's named
   parameters, so it can group them by name.

Where it differs:

 - ``use_bf16_compute`` runs the forward under
   ``torch.autocast(..., torch.bfloat16)``: parameters stay float32
   master weights and autocast casts each conv and matmul's inputs to
   bf16.  The JAX trainer instead casts the whole params tree and the
   inputs to bf16 before the forward (its ``_loss_and_grads``), so its
   gradients come back through a bf16 cast of every parameter.  The two
   round in different places; they agree in float32 mode.
 - The optimizer updates the module's parameters in place (the JAX
   trainer donates the old buffers instead).
 - PyTorch leaves TF32 on for float32 convs on the card; an entry point
   that wants float32 to compute in float32 calls
   ``utils.device.use_float32_numerics()`` first (``chip_smoke.py``
   does).  The trainer changes no process-wide setting.

What the worker's task loop uses (``worker/worker.py``,
``worker/fused_driver.py``):

 - ``prepare_batch`` is host work only: it pads and reshapes on the
   host (CPU tensors) and touches no device, so the fused driver's
   prefetch producer thread may run it.  The copy to the card happens
   on the thread that dispatches the step, on its current stream
   (``train_minibatch``, ``stage_window``), so the copy and the step are
   ordered by the stream itself;
 - version reports to the master every ``report_version_steps`` steps
   through the master client, and checkpoints every
   ``checkpoint_steps``;
 - the fused-window API (``max_window``, ``steps_to_boundary``,
   ``stage_window``, ``train_window``, ``build_fused_window``,
   ``build_fused_steps``).  A window of K is K optimizer steps issued
   back to back with no host sync between them; the losses stay on the
   device until the driver fetches them.  It is not one captured
   program (the JAX trainer's unrolled ``lax.scan``): each step is the
   same ``_train_step`` a ``train_minibatch`` runs, on its own
   device copy of its batch, so a window equals K single steps bitwise.

Over a mesh (``rebuild``, called by the constructor and by the elastic
controller at every rendezvous epoch) each rank trains on its own task
stream's local batch, padded to ``batch_size`` rows, and the loss is the
weighted mean over the global batch, the concatenation of the ranks'
local batches, as the JAX trainer's ``_globalize`` gives it: each rank
backpropagates its local weighted loss sum, then the gradients, the sum
and the weight count go through one ``transport.all_reduce_grads_`` over
the whole world and are divided by the global count.  The forward runs
inside ``parallel.mesh.batch_split`` of the world (``Mesh.flat``), so a
model's statistics over the batch (the MoE router's aux) are the global
batch's, as in the JAX trainer's one GSPMD program.

A mesh with axes other than dp (pp, ep, tp, sp) runs the JAX trainer's
arithmetic with its ``data_axis`` "dp": the parameters are replicated
over the whole mesh and rank 0's state is broadcast over all of it, and
ZeRO-1 shards over ``dp`` and is replicated over the other axes.  The
ranks that share a ``dp`` coordinate are replicas of one another and
are to be fed the same rows: the JAX trainer assumes it
(``make_array_from_process_local_data`` takes the fixed axes as lying
inside one process, as they do on a TPU host), while the task stream of
``worker/worker.py`` hands each rank tasks of its own and
``api/controller.compute_accum_steps`` counts microbatches by rank over
the world's size, not over ``dp``.  The loss, the weight count and the
gradients are still summed over the whole world, not over ``dp`` alone:
replicas fed the same rows count each row once per replica in the sum
and in the count alike, so the mean is the JAX trainer's over ``dp``,
and replicas fed rows of their own each add them to the step.  Every
rank then steps on the same all-reduced gradients, so the replicas stay
bit for bit one another, whatever their devices' algorithms compute
apart (cuDNN's default ones do not reproduce across processes).  On one
device a rank holds the whole model: the fixed axes only replicate the
step.  With accumulation each microbatch's mean is over the global
microbatch (its count is summed first), as the JAX scan over global
microbatches.  Padded rows weigh 0 on every rank.
At every epoch of more than one rank, ``rebuild`` hands rank 0's
parameters, optimizer state and version to the world (the oldest
survivor's, since ranks are in join order), so a replacement that
restored an older checkpoint, or a fresh rank, adopts them bit for bit.
Evaluation and prediction run on the local copy and never enter a
collective (the JAX ``_forward_local``).  A multi-process world trains
one step per dispatch (``max_window`` 1), as the JAX trainer does.

ZeRO-1 (``zero1=True``; ``worker/zero.py``): in a world whose ``dp`` is
N > 1 each rank holds a flat padded 1/N shard of every optimizer slot
and of every parameter the optimizer updates, and a shard optimizer
(the spec's, over the shard tensors under the parameters' names) steps
it.  A step reduces the gradients as the replicated path does (one
all-reduce, divided by the global count), slices each rank's shard out
of them, steps the shard optimizer and all-gathers the fresh shards
over ``dp`` into the parameters (``transport.all_gather_flat_``), so the
trajectory is
bit-equal to ``zero1=False``.  Alone, the trainer runs the whole
optimizer as without ZeRO-1.  Where the JAX trainer gathers the shards
before a world re-forms (its ``snapshot_to_host``), the port's ranks
leave a world at different moments, so the shards are put back together
in ``rebuild``, over the new world's group: they survive, bit for bit,
when the new world holds every shard of rank 0's layout at its version,
and otherwise the moments restart from the parameters (a leaver, a
killed peer, a planned shrink; ``zero1_moment_resets``).  Checkpoints
hold the whole state in original shapes, gathered at the cadence by
every rank of the world (``checkpoint_writer`` says which one writes),
and move between ZeRO-1 on, off and the JAX package.

Continuous servable export (the online-learning loop's trainer half):
with an ``exporter`` (``serving/export.ContinuousExporter``) and
``export_steps``, every ``export_steps`` optimizer steps the parameters
are copied to the host on the training thread and the versioned
servable is written on the checkpoints' single background writer, as
the JAX trainer does; ``serving_bundle`` is fixed by the first
minibatch's features.  Worker 0 alone exports (``worker/main.py``).

"""

import concurrent.futures
import os

import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.parallel import transport
from elasticdl_tpu_torch.parallel.mesh import batch_split
from elasticdl_tpu_torch.serving.export import ServingFunction
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.pytree import tree_leaves, tree_map
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.fused_driver import (
    PreparedBatch,
    StagedWindow,
)
from elasticdl_tpu_torch.worker.trainer import Trainer
from elasticdl_tpu_torch.worker.zero import ZeroPartitioner

logger = get_logger(__name__)


def _masked_mean(per_example, weights):
    per_example = per_example.reshape(per_example.shape[0], -1).mean(dim=-1)
    return (per_example * weights).sum() / weights.sum().clamp_min(1.0)


def _pad_rows(t, rows):
    """Zero rows appended to ``t`` up to ``rows``."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _pad_batch(tree, batch_size):
    """Pad every leaf of ``tree`` (a tensor, or a tree of dicts, lists
    and tuples of them) to batch_size rows; returns (padded, weights)."""
    first = tree_leaves(tree)[0]
    n = first.shape[0]
    if n > batch_size:
        raise ValueError(
            "minibatch has %d records > trainer's global batch %d"
            % (n, batch_size)
        )
    weights = torch.zeros(batch_size, dtype=torch.float32,
                          device=first.device)
    weights[:n] = 1.0
    return tree_map(lambda leaf: _pad_rows(leaf, batch_size), tree), weights


def _host_tensor(a):
    """A batch leaf as a tensor, without a device copy: an ndarray (or
    array-like) becomes a CPU tensor; a tensor stays where it is."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


# Adam and AdamW keep the same slots; whether AdamW subclasses Adam
# depends on the torch version, so both are named.
_ADAM = (torch.optim.Adam, torch.optim.AdamW)


def _grouped(optimizer, named_params):
    """(name prefix, JAX name, parameter) of each parameter the optimizer
    updates, group by group (``_opt_state_to_jax``)."""
    names = {p: name for name, p in named_params}
    return [(group.get("jax_prefix", ""), names[p], p)
            for group in optimizer.param_groups for p in group["params"]]


def _jax_slots(optimizer, named_params):
    """(optax name, torch state key, parameter) of each leaf of the optax
    state a torch optimizer stands for, in ``flatten_with_names`` order;
    an Adam count is (name, None, None)."""
    if isinstance(optimizer, torch.optim.SGD):
        if not optimizer.defaults["momentum"]:
            return []
        return [(prefix + "0/trace/" + name, "momentum_buffer", p)
                for prefix, name, p in _grouped(optimizer, named_params)]
    if isinstance(optimizer, _ADAM):
        out = [(group.get("jax_prefix", "") + "0/count", None, None)
               for group in optimizer.param_groups]
        for prefix, name, p in _grouped(optimizer, named_params):
            out += [(prefix + "0/mu/" + name, "exp_avg", p),
                    (prefix + "0/nu/" + name, "exp_avg_sq", p)]
        return out
    raise NotImplementedError(
        "no checkpoint mapping for optimizer %s" % type(optimizer).__name__)


def _opt_state_geometry(optimizer, named_params):
    """``[(name, shape, dtype)]`` of each leaf ``_opt_state_to_jax``
    gives (a count: shape (), int32), without making any."""
    return [(name, (), np.int32) if key is None
            else (name, tuple(p.shape), p.dtype)
            for name, key, p in _jax_slots(optimizer, named_params)]


def _opt_state_to_jax(optimizer, named_params, to_jax_layout):
    """A torch optimizer's state -> ``{name: ndarray}`` as
    ``flatten_with_names`` names the optax state it stands for, each slot
    in its parameter's JAX layout.  A slot not created yet (before the
    first step) is saved as optax's initial value: zeros."""
    # Every group steps together, so each optax count is the step.
    count = max((int(s["step"]) for s in optimizer.state.values()
                 if "step" in s), default=0)
    out = {}
    for name, key, p in _jax_slots(optimizer, named_params):
        if key is None:
            out[name] = np.asarray(count, np.int32)
            continue
        value = optimizer.state.get(p, {}).get(key)
        out[name] = to_jax_layout(value if value is not None
                                  else torch.zeros_like(p))
    return out


def _opt_state_from_jax(optimizer, named_params, named, from_jax_layout):
    """Load ``{name: ndarray}`` (``_opt_state_to_jax``'s names and
    layouts) into a fresh torch optimizer.  Raises KeyError for a missing
    slot and ValueError for a slot of the wrong shape."""
    def slot(key, p):
        value = from_jax_layout(named[key])
        if value.shape != p.shape:
            raise ValueError("%s has shape %s, the parameter %s" % (
                key, tuple(value.shape), tuple(p.shape)))
        # In the parameter's own memory layout (channels-last convs).
        return torch.empty_like(p).copy_(value)

    if isinstance(optimizer, torch.optim.SGD):
        if optimizer.defaults["momentum"]:
            for prefix, name, p in _grouped(optimizer, named_params):
                optimizer.state[p]["momentum_buffer"] = slot(
                    prefix + "0/trace/" + name, p)
        return
    if isinstance(optimizer, _ADAM):
        for prefix, name, p in _grouped(optimizer, named_params):
            count = float(np.asarray(named[prefix + "0/count"]))
            optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": slot(prefix + "0/mu/" + name, p),
                "exp_avg_sq": slot(prefix + "0/nu/" + name, p),
            }
        return
    raise NotImplementedError(
        "no checkpoint mapping for optimizer %s" % type(optimizer).__name__)


def _identity(t):
    return t


def _host_zeros(a):
    """A host ndarray of zeros with ``a``'s shape and dtype, without
    copying ``a`` (which may be a tensor on the card)."""
    if isinstance(a, torch.Tensor):
        return torch.zeros(a.shape, dtype=a.dtype).numpy()
    return np.zeros(np.shape(a), np.asarray(a).dtype)


def _nonce():
    """A random 62-bit id (a ZeRO-1 layout's, see ``_exchange_shards``)."""
    return int.from_bytes(os.urandom(8), "little") >> 2


def _holders(rows):
    """Which rank of a new world holds each shard of rank 0's ZeRO-1
    layout, from every member's descriptor ``(layout world size, layout
    rank, layout id, version, finished, nonce)`` in new-rank order: a list
    indexed by the layout's rank, or None when a shard of it is missing,
    at another version or unfinished (a step failed between the shard
    update and the parameter all-gather)."""
    world, _, layout_id, version, finished = rows[0][:5]
    if not finished:
        return None
    holders = {}
    for new_rank, row in enumerate(rows):
        if (row[0], row[2], row[3], row[4]) == (world, layout_id, version, 1):
            holders.setdefault(row[1], new_rank)
    if len(holders) < world:
        return None
    return [holders[r] for r in range(world)]


class CollectiveTrainer(Trainer):
    def __init__(
        self,
        spec,
        batch_size,
        accum_steps=1,
        rng_seed=0,
        master_client=None,
        report_version_steps=0,
        checkpoint_saver=None,
        checkpoint_steps=0,
        use_bf16_compute=False,
        device=None,
        mesh=None,
        zero1=False,
        exporter=None,
        export_steps=0,
        checkpoint_writer=True,
    ):
        self._spec = spec
        self._batch_size = batch_size
        self._accum_steps = accum_steps
        self._mc = master_client
        self._report_version_steps = report_version_steps
        self._checkpoint_saver = checkpoint_saver
        self._checkpoint_steps = checkpoint_steps
        # Whether the checkpoint cadence writes; a rank that does not
        # still joins a ZeRO-1 world's gather at it.
        self._checkpoint_writer = checkpoint_writer
        # Continuous servable export: every export_steps optimizer steps
        # a complete versioned servable lands at the exporter's base.
        self._exporter = exporter
        self._export_steps = export_steps if exporter is not None else 0
        self._export_future = None
        self._example_features = None
        self._use_bf16_compute = use_bf16_compute
        self._device = resolve_device(device)
        self.timing = Timing(logger=logger)
        self._version = 0
        self._ckpt_executor = None
        self._ckpt_future = None
        self._module = spec.init_fn(self._device, rng_seed)
        self._optimizer = self._new_optimizer()
        # ZeRO-1 (module docstring): the state is whole in _optimizer
        # while _zero is None, else this rank's shards are in _shard_opt.
        # _layout names the layout the state was cut for (world size,
        # rank, id); _shard_finished is False from a shard step until
        # its parameters are gathered.
        self._zero1 = zero1
        self._drop_shards()
        self._layout = (1, 0, _nonce())
        self._shard_finished = True
        self.rebuild(mesh)

    # -- mesh / world management --------------------------------------------

    def snapshot_to_host(self):
        """The elastic controller's hook before the world is re-formed or
        left.  The JAX trainer pulls its state to the host here, because
        re-forming its world clears the device backends; a torch world's
        re-forming leaves the parameters and optimizer state on the card,
        so nothing moves, and nothing here enters a collective (the
        members of a world do not agree on when they leave it).  What
        this does instead is let go of the old world's mesh (the trainer
        trains alone until the next ``rebuild``): its groups' sockets then
        close when the world is destroyed, and a peer still blocked in one
        of their collectives fails at once, not at the timeout.  ZeRO-1
        shards stay as they are: the next ``rebuild`` puts them back
        together if the new world holds them all."""
        self._set_mesh(None)

    def _set_mesh(self, mesh):
        """The world's sizes, this rank's places and its groups: the
        whole mesh's (the state broadcast, the loss and gradient sums and
        the ZeRO-1 exchange) and that of ``dp`` (the ZeRO-1 shards),
        None where ``dp`` is 1.  Read once: a world the controller has
        left is destroyed under the mesh, which rebuild() replaces before
        the next step."""
        self._mesh = mesh
        alone = mesh is None
        self._world_size = (1 if alone else
                            torch.distributed.get_world_size(mesh.group()))
        self._rank = 0 if alone else torch.distributed.get_rank(mesh.group())
        self._batch_mesh = None if alone else mesh.flat()
        self._dp_group = (None if alone or mesh.shape["dp"] == 1
                          else mesh.group("dp"))

    @property
    def _dp_size(self):
        """Ranks along ``dp``: the mesh's, or, with none, the world's."""
        return (self._world_size if self._mesh is None
                else self._mesh.shape["dp"])

    @property
    def _dp_rank(self):
        return self._rank if self._mesh is None else self._mesh.coords["dp"]

    def rebuild(self, mesh):
        """Train over ``mesh`` from now on (None: alone).  Called at
        construction and at every rendezvous epoch.  Parameters,
        optimizer state and version stay where they are; in a world of
        more than one rank, rank 0's are broadcast to all (the
        epoch-start sync), and under ZeRO-1 the state is first put back
        together from the members' shards (``_exchange_shards``) and then
        cut anew for this world's ``dp``.  A mesh may have any axes
        (module docstring).  The port keeps no per-world caches (pad
        plans or compiled windows), so there is nothing else to drop."""
        self._set_mesh(mesh)
        if self.process_count > 1:
            with self.timing.timeit("state_broadcast"):
                layout_id = self._exchange_shards() if self._zero1 else None
                self._adopt_rank0_state()
                if self._sharded():
                    self._cut(layout_id)
                elif self._zero1:
                    # dp of 1: every rank holds rank 0's state whole.
                    self._layout = (1, 0, layout_id)
            logger.info(
                "world of %d ranks: adopted rank 0's parameters, optimizer "
                "state and version %d", self.process_count, self._version)
            if self._zero is not None:
                self._log_zero1_placement()
        elif self._zero is not None:
            self._settle_alone()

    def _group(self):
        """The group the ZeRO-1 shards are gathered over: the world's
        ``dp``, or None when training alone or where ``dp`` is 1 (every
        rank then holds the optimizer state whole)."""
        return self._dp_group if self.process_count > 1 else None

    def _sharded(self):
        """Whether the optimizer state is cut into ZeRO-1 shards: on, in
        a world whose ``dp`` is more than 1."""
        return self._zero1 and self.process_count > 1 and self._dp_size > 1

    def _adopt_rank0_state(self):
        """Overwrite this rank's parameters, buffers, optimizer state and
        version with rank 0's, bit for bit.  Optimizer slots not created
        yet go as their initial value (zeros, step 0), which is what
        torch's SGD (dampening 0) and Adam would start from."""
        named = self._named_params()
        opt = _opt_state_to_jax(self._optimizer, named, _identity)
        slots = sorted(k for k in opt if isinstance(opt[k], torch.Tensor))
        counts = sorted(k for k in opt if k not in slots)
        scalars = torch.tensor(
            [float(self._version)] + [float(opt[k]) for k in counts],
            dtype=torch.float64, device=self._device)
        state = ([p.data for p in self._module.parameters()]
                 + list(self._module.buffers())
                 + [opt[k] for k in slots] + [scalars])
        transport.broadcast_(state, self._mesh.group())
        values = scalars.tolist()
        self._version = int(values[0])
        for k, v in zip(counts, values[1:]):
            opt[k] = np.asarray(v, np.int32)
        _opt_state_from_jax(self._optimizer, named, opt, _identity)

    # -- ZeRO-1 --------------------------------------------------------------

    def _drop_shards(self):
        self._zero = None
        self._shards = None
        self._shard_opt = None

    def _opt_params(self):
        """(module name, parameter) of each parameter the optimizer
        updates, group by group."""
        names = {p: name for name, p in self._module.named_parameters()}
        return [(names[p], p) for group in self._optimizer.param_groups
                for p in group["params"]]

    def _partitioner(self, num_shards, rank=0):
        """The ZeRO-1 layout of this model and optimizer over
        ``num_shards`` ranks."""
        return ZeroPartitioner(
            [(jax_name(name), tuple(p.shape), p.dtype)
             for name, p in self._opt_params()],
            _opt_state_geometry(self._optimizer, self._named_params()),
            num_shards, rank)

    def _named_shards(self):
        return [(jax_name(name), s) for (name, _), s in
                zip(self._opt_params(), self._shards)]

    def _cut(self, layout_id):
        """Cut the whole optimizer state (``_optimizer``'s) and the
        parameters into this rank's shards of the world's layout over
        ``dp`` (replicas along the other axes hold the same shard); the
        whole state is dropped.  The shard optimizer is the spec's,
        called with the shard tensors under the parameters' names, so it
        has the same groups and hyper-parameters and picks the same torch
        implementation (foreach on the card, the for-loop on the CPU)."""
        zero = self._partitioner(self._dp_size, self._dp_rank)
        whole = _opt_state_to_jax(self._optimizer, self._named_params(),
                                  _identity)
        params = self._opt_params()
        shards = [zero.cut(p.detach(), spec)
                  for (_, p), spec in zip(params, zero.param_specs)]
        shard_opt = self._spec.optimizer(
            [(name, s) for (name, _), s in zip(params, shards)])
        self._optimizer = self._new_optimizer()   # groups only, no state
        self._zero, self._shards, self._shard_opt = zero, shards, shard_opt
        _opt_state_from_jax(shard_opt, self._named_shards(),
                            zero.cut_state(whole), _identity)
        self._layout = (self._dp_size, self._dp_rank, layout_id)
        self._shard_finished = True

    def _restart_moments(self, why):
        """The optimizer state afresh, whole (JAX ``snapshot_to_host``'s
        fallback: moments re-initialised, parameters kept).  A trainer
        that never stepped loses nothing, so only a later one counts."""
        if self._version > 0:
            self.timing.bump("zero1_moment_resets")
            logger.warning(
                "zero1: %s; re-initializing optimizer moments from params "
                "(version %d)", why, self._version)
        self._drop_shards()
        self._optimizer = self._new_optimizer()
        self._layout = (1, 0, _nonce())
        self._shard_finished = True

    def _settle_alone(self):
        """Alone with the shards of a world of 2+: the other shards went
        with that world, so the moments restart."""
        self._restart_moments(
            "alone with 1 of the %d shards of the optimizer state"
            % self._layout[0])

    def _shard_state(self):
        """This rank's shards of its layout, ``{optax name: tensor}``."""
        return _opt_state_to_jax(self._shard_opt, self._named_shards(),
                                 _identity)

    def _gather_layout(self, group, zero, holders, mine, counter):
        """The whole optimizer state of layout ``zero``, put back together
        on every rank of ``group`` by one all-gather: rank ``holders[r]``
        gives shard r (``mine``, this rank's shards, or None for a rank
        that holds none).  Returns ``{optax name: tensor}`` in original
        shapes (counts as int32 arrays, scalars from shard 0); the bytes
        received go to the timing counter ``counter``."""
        n = torch.distributed.get_world_size(group)
        sends = []
        for name, spec, dtype in zip(zero.state_names, zero.state_specs,
                                     zero.state_dtypes):
            count = not isinstance(dtype, torch.dtype)
            if mine is None:
                k = zero.shard_len(spec) or 1
                sends.append(torch.zeros(
                    k, dtype=torch.int64 if count else dtype,
                    device=self._device))
            elif count:
                sends.append(torch.tensor(
                    [int(np.asarray(mine[name]))], dtype=torch.int64,
                    device=self._device))
            else:
                sends.append(mine[name].reshape(-1))
        outs = [t.new_empty(n * t.numel()) for t in sends]
        transport.all_gather_flat_(outs, sends, group)
        self.timing.bump(counter, sum(t.numel() * t.element_size()
                                      for t in outs))
        shards = [{} for _ in holders]
        for name, spec, dtype, out in zip(zero.state_names, zero.state_specs,
                                          zero.state_dtypes, outs):
            rows = out.view(n, -1)
            for r, h in enumerate(holders):
                if not isinstance(dtype, torch.dtype):
                    shards[r][name] = np.asarray(int(rows[h][0]), np.int32)
                elif spec.padded:
                    shards[r][name] = rows[h]
                else:
                    shards[r][name] = rows[h].reshape(())
        return zero.assemble_state(shards)

    def _exchange_shards(self):
        """The ZeRO-1 half of a re-form, over the NEW world's group (its
        members reach it together, having just formed it).  Each member
        gives a descriptor of the state it holds: the layout it was cut
        for (world size, rank, id), its version, and whether its last
        shard step finished (one that failed before its parameters were
        gathered leaves the shard a step ahead of them).  If the finished
        shards at rank 0's version cover every shard of rank 0's layout,
        the whole state is put back together from them into
        ``_optimizer``, bit for bit (the contract of JAX
        ``ZeroPartitioner.repartition``); otherwise the moments restart.
        Returns the new layout's id (rank 0's draw)."""
        group = self._mesh.group()
        n = self.process_count
        world, rank, layout_id = self._layout
        mine = torch.tensor([world, rank, layout_id, self._version,
                             int(self._shard_finished), _nonce()],
                            dtype=torch.int64)
        rows = torch.empty(n * mine.numel(), dtype=torch.int64)
        transport.all_gather_flat_([rows], [mine], group)
        rows = rows.view(n, -1).tolist()
        holders = _holders(rows)
        if holders is None:
            self._restart_moments(
                "the shards of the optimizer state at rank 0's version are "
                "not all in this world of %d" % n)
            return rows[0][5]
        if rows[0][0] == 1:
            # Rank 0 holds the state whole: its broadcast carries it.
            if self._rank:
                self._drop_shards()
            self.timing.bump("zero1_repartitions")
            return rows[0][5]
        old = self._partitioner(rows[0][0])
        whole = self._gather_layout(
            group, old, holders,
            self._shard_state() if self._rank in holders else None,
            "zero1_reshard_bytes")
        self._drop_shards()
        self._optimizer = self._new_optimizer()
        _opt_state_from_jax(self._optimizer, self._named_params(), whole,
                            _identity)
        self.timing.bump("zero1_repartitions")
        return rows[0][5]

    def _whole_state(self):
        """``{optax name: tensor}``, the whole optimizer state in the
        parameters' torch layouts; under ZeRO-1 in a world, an all-gather
        every rank of the world must enter at the same step."""
        group = self._group()
        if self._zero is None:
            return _opt_state_to_jax(self._optimizer, self._named_params(),
                                     _identity)
        if group is None:
            self._settle_alone()
            return self._whole_state()
        return self._gather_layout(group, self._zero,
                                   list(range(self._dp_size)),
                                   self._shard_state(),
                                   "zero1_checkpoint_gather_bytes")

    def _zero1_update(self, group):
        """The weight update of a ZeRO-1 rank: the gradients (already
        summed over the world, as the replicated path's) sliced to this
        rank's shards, the shard optimizer's step, then the shards
        all-gathered into the parameters, unpadded.  All-reduce then
        slice, not a reduce-scatter: the sum lands where the replicated
        path's does, so the gradients are bit-equal to it at any world
        size (the JAX design's pin 1)."""
        zero = self._zero
        params = [p for _, p in self._opt_params()]
        for p, s, spec in zip(params, self._shards, zero.param_specs):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            s.grad = zero.cut(g, spec)
        self._shard_finished = False
        self._shard_opt.step()
        sharded = [(p, s, spec) for p, s, spec in
                   zip(params, self._shards, zero.param_specs) if spec.padded]
        fulls = [s.new_empty(spec.padded) for _, s, spec in sharded]
        transport.all_gather_flat_(fulls, [s for _, s, _ in sharded], group)
        with torch.no_grad():
            for (p, _, spec), full in zip(sharded, fulls):
                p.copy_(zero.unflatten_leaf(full, spec))
            for p, s, spec in zip(params, self._shards, zero.param_specs):
                if not spec.padded:
                    p.copy_(s)
        self._shard_finished = True
        flat_bytes = zero.flat_param_bytes()
        self.timing.bump("zero1_reduce_scatter_bytes", flat_bytes)
        self.timing.bump("zero1_all_gather_bytes", flat_bytes)

    @property
    def global_device_count(self):
        """Devices of the world: one per rank."""
        return self.process_count

    @property
    def process_count(self):
        """Ranks of the world (1: training alone)."""
        return self._world_size

    def _new_optimizer(self):
        return self._spec.optimizer(self._module.named_parameters())

    def set_accum_steps(self, accum_steps):
        self._accum_steps = accum_steps

    def _named_params(self):
        return [(jax_name(name), p)
                for name, p in self._module.named_parameters()]

    def _as_tensor(self, a):
        return torch.as_tensor(a if isinstance(a, torch.Tensor)
                               else np.asarray(a), device=self._device)

    def _to_device(self, tree):
        """Copy a host batch tree to the trainer's device on the calling
        thread's current stream (a no-op for leaves already there).
        From pinned memory the copy is asynchronous and still ordered
        before every later step on that stream."""
        def put(t):
            if self._device.type == "cuda" and not t.is_cuda:
                return t.pin_memory().to(self._device, non_blocking=True)
            return t.to(self._device)

        return tree_map(put, tree)

    def _loss_and_grads(self, features, labels, weights, scale=None):
        """Forward and backward of one (micro)batch; the gradients add
        into ``.grad``.  Returns the loss, detached: the masked mean, or
        with ``scale`` (a scalar tensor) the weighted sum times it."""
        self.timing.bump("train_passes")
        with torch.autocast(self._device.type, dtype=torch.bfloat16,
                            enabled=self._use_bf16_compute), \
                batch_split(self._batch_mesh):
            out = self._spec.apply_fn(self._module, features, True)
        per_example = self._spec.loss_fn(out, labels).float()
        if scale is None:
            loss = _masked_mean(per_example, weights)
        else:
            per_example = per_example.reshape(
                per_example.shape[0], -1).mean(dim=-1)
            loss = (per_example * weights).sum() * scale
        loss.backward()
        return loss.detach()

    def _world_step_grads(self, features, labels, weights, group):
        """The gradients of one step in a world of more than one rank,
        summed over its ``group`` into every rank's ``.grad``; returns
        the global mean loss (the same scalar on every rank)."""
        accum = self._accum_steps
        params = list(self._module.parameters())
        if accum == 1:
            one = torch.ones((), device=weights.device)
            loss_sum = self._loss_and_grads(features, labels, weights, one)
            total = torch.stack([loss_sum, weights.sum()])
            transport.all_reduce_grads_(params, group, [total])
            count = total[1].clamp_min(1.0)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(count)
            return total[0] / count
        # Each microbatch's mean is over the global microbatch, so its
        # count is summed before its backward.
        counts = weights.sum(dim=1)
        transport.all_reduce_sum_([counts], group)
        scales = 1.0 / (counts.clamp_min(1.0) * accum)
        loss = torch.zeros(1, device=weights.device)
        for i in range(accum):
            micro_features, micro_labels = tree_map(
                lambda leaf: leaf[i], (features, labels))
            loss += self._loss_and_grads(micro_features, micro_labels,
                                         weights[i], scales[i])
        transport.all_reduce_grads_(params, group, [loss])
        return loss[0]

    def _train_step(self, features, labels, weights):
        self._module.train()
        self._optimizer.zero_grad(set_to_none=True)
        accum = self._accum_steps
        group = self._group()
        if group is None and self._zero is not None:
            self._settle_alone()
        if self.process_count > 1:
            loss = self._world_step_grads(features, labels, weights,
                                          self._mesh.group())
        elif accum == 1:
            loss = self._loss_and_grads(features, labels, weights)
        else:
            loss = 0.0
            for i in range(accum):
                micro_features, micro_labels = tree_map(
                    lambda leaf: leaf[i], (features, labels))
                loss = loss + self._loss_and_grads(
                    micro_features, micro_labels, weights[i])
            for p in self._module.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = loss / accum
        if self._zero is not None:
            self._zero1_update(group)
        else:
            self._optimizer.step()
        return loss

    # -- Trainer API --------------------------------------------------------

    def prepare_batch(self, features, labels, count=None):
        """Host-side batch prep: pad to the static batch (with the loss
        mask) and reshape for accumulation, on CPU tensors.  It touches
        no device, so it may run on the prefetch producer thread; the
        step's thread copies the result to the card."""
        if self._example_features is None:
            # Shape/dtype skeleton of one raw minibatch (host arrays, or
            # tensors already on the card): it fixes the serving
            # signature of the servable exports.
            self._example_features = tree_map(_host_zeros, features)
        with self.timing.timeit("batch_prep"):
            batch = tree_map(_host_tensor, (features, labels))
            n = int(tree_leaves(batch)[0].shape[0])
            accum, micro = self._accum_steps, self._batch_size
            batch, weights = _pad_batch(batch, accum * micro)
            if accum > 1:
                batch = tree_map(
                    lambda leaf: leaf.reshape((accum, micro)
                                              + tuple(leaf.shape[1:])),
                    batch)
                weights = weights.reshape(accum, micro)
        return PreparedBatch(batch[0], batch[1], weights,
                             n if count is None else count)

    def train_minibatch(self, features, labels):
        """One step; returns (loss, version) where ``loss`` is a LAZY
        device scalar: no host sync here.  ``float(loss)`` is the
        fence."""
        staged = self.stage_window([self.prepare_batch(features, labels)])
        with self.timing.timeit("step_dispatch"):
            loss = self._train_step(staged.features, staged.labels,
                                    staged.weights)
        self._version += 1
        self._maybe_report_and_checkpoint()
        return loss, self._version

    # -- fused window API (fused_driver.FusedStepDriver) --------------------

    @property
    def max_window(self):
        """None (unbounded) when training alone; 1 in a world of more
        than one rank, as the JAX trainer: a collective failure then
        surfaces on its own minibatch, inside the worker's retry scope."""
        return 1 if self.process_count > 1 else None

    def steps_to_boundary(self):
        """Steps until the next version-report or checkpoint cadence
        boundary: the fused driver clamps windows to it so those events
        land on exactly the per-step loop's step numbers."""
        dists = []
        if self._mc is not None and self._report_version_steps:
            dists.append(
                self._report_version_steps
                - self._version % self._report_version_steps
            )
        if (self._checkpoint_saver is not None and self._checkpoint_steps
                and self._checkpoint_writer):
            dists.append(
                self._checkpoint_steps
                - self._version % self._checkpoint_steps
            )
        if self._export_steps:
            dists.append(
                self._export_steps - self._version % self._export_steps
            )
        return min(dists) if dists else None

    def stage_window(self, prepared, to_device=True):
        """K prepared batches -> a ``StagedWindow``; ``to_device`` starts
        their copy to the card now, on the calling thread's stream.  A
        window of 1 keeps the batch's own trees; a longer one holds a
        tuple of K per-step trees in each field (not one stacked array:
        each step reads its own device copy, exactly as a single step
        does)."""
        put = self._to_device if to_device else (lambda tree: tree)
        if len(prepared) == 1:
            b = prepared[0]
            return StagedWindow(1, put(b.features), put(b.labels),
                                put(b.weights))
        return StagedWindow(
            len(prepared),
            tuple(put(b.features) for b in prepared),
            tuple(put(b.labels) for b in prepared),
            tuple(put(b.weights) for b in prepared),
        )

    def build_fused_window(self, num_steps):
        """fn(features, labels, weights) -> losses[num_steps]: the
        num_steps optimizer steps of one window, each over its own
        minibatch (``stage_window``'s per-step tuples), issued with no
        host sync; the stacked losses stay on the device."""
        def window(features, labels, weights):
            if not len(features) == len(labels) == len(weights) \
                    == num_steps:
                raise ValueError("a window of %d steps got %d batches"
                                 % (num_steps, len(features)))
            return torch.stack([
                self._train_step(*self._to_device((f, l, w)))
                for f, l, w in zip(features, labels, weights)
            ])

        return window

    def build_fused_steps(self, num_steps):
        """fn(features, labels, weights) -> last loss: num_steps
        optimizer steps over ONE fixed batch with no host sync between
        them (the bench's steps-per-loop form)."""
        def multi(features, labels, weights):
            features, labels, weights = self._to_device(
                (features, labels, weights))
            loss = None
            for _ in range(num_steps):
                loss = self._train_step(features, labels, weights)
            return loss

        return multi

    def train_window(self, staged):
        """Dispatch one staged window; returns (device losses, version
        after the window).  The caller clamps K to
        ``steps_to_boundary`` (fused_driver does): report and
        checkpoint cadences are checked once, at the window's end."""
        if staged.size == 1:
            with self.timing.timeit("step_dispatch"):
                losses = self._train_step(*self._to_device(
                    (staged.features, staged.labels, staged.weights)))
        else:
            with self.timing.timeit("step_dispatch"):
                losses = self.build_fused_window(staged.size)(
                    staged.features, staged.labels, staged.weights)
        self._version += staged.size
        self._maybe_report_and_checkpoint()
        return losses, self._version

    def _maybe_report_and_checkpoint(self):
        if (
            self._mc is not None
            and self._report_version_steps
            and self._version % self._report_version_steps == 0
        ):
            self._mc.report_version(self._version)
        if (
            self._checkpoint_saver is not None
            and self._checkpoint_steps
            and self._version % self._checkpoint_steps == 0
        ):
            # Every rank of a ZeRO-1 world is here at the same version,
            # so each joins the gather; only the writer writes.
            sharded = self._zero is not None and self._group() is not None
            if self._checkpoint_writer:
                self._queue_checkpoint(self._whole_state())
            elif sharded:
                self._whole_state()
        if self._export_steps and self._version % self._export_steps == 0:
            self.export_servable_now()

    def _forward(self, features):
        """Inference on this process's copy of the parameters: in a
        world of more than one rank it enters no collective (an eval
        task is one worker's, the JAX ``_forward_local``)."""
        features = tree_map(self._as_tensor, features)
        n = int(tree_leaves(features)[0].shape[0])
        padded, _ = _pad_batch(features, self._batch_size)
        self._module.eval()
        with torch.inference_mode():
            out = self._spec.apply_fn(self._module, padded, False)
        return tree_map(lambda t: t[:n].float().cpu().numpy(), out)

    def evaluate_minibatch(self, features, labels):
        return self._forward(features), np.asarray(labels)

    def predict_minibatch(self, features):
        return self._forward(features)

    # -- state --------------------------------------------------------------

    @property
    def version(self):
        return self._version

    @property
    def module(self):
        """The ``nn.Module`` being trained (its parameters are updated in
        place; after a step their ``.grad`` holds that step's
        gradients)."""
        return self._module

    @property
    def params(self):
        """The module's ``state_dict`` (live tensors)."""
        return self._module.state_dict()

    def set_params(self, state_dict):
        """Load a ``state_dict`` (``spec.params_from_jax`` makes one from
        JAX names) and start the optimizer afresh, as the JAX trainer
        re-inits its optimizer state."""
        self._module.load_state_dict(state_dict)
        self._load_whole_state(None)

    def _load_whole_state(self, opt_named, from_jax_layout=_identity):
        """A fresh optimizer, loaded from ``opt_named``
        (``_opt_state_to_jax``'s names; None: initial state) and, under
        ZeRO-1 in a world, cut for it in its current layout (every rank
        loads the same state, so the shards agree without a collective)."""
        self._drop_shards()
        self._optimizer = self._new_optimizer()
        try:
            if opt_named:
                _opt_state_from_jax(self._optimizer, self._named_params(),
                                    opt_named, from_jax_layout)
        except (KeyError, ValueError) as e:
            # Optimizer changed since the checkpoint (e.g. Adam ->
            # momentum): params are still good, trajectory is not.
            logger.warning(
                "checkpoint optimizer state incompatible (%s); "
                "re-initializing optimizer", e,
            )
            self._optimizer = self._new_optimizer()
        if self._sharded():
            self._cut(self._layout[2])
        else:
            self._layout = (1, 0, self._layout[2])
            self._shard_finished = True

    def export_parameters(self):
        """``{JAX name: ndarray}`` in the JAX layouts (host copies)."""
        return self._spec.params_to_jax(self._module)

    def serving_bundle(self):
        """(serving function, parameters, example input) for a servable
        export (``serving/export.write_servable``); None before the
        first minibatch fixed the signature."""
        if self._example_features is None:
            return None
        return (ServingFunction(self._spec, self._module),
                self.export_parameters(), self._example_features)

    def export_servable_now(self):
        """The continuous-export hook (``export_steps`` cadence): copy
        the parameters to the host here (the next step updates them in
        place), then write the versioned servable on the checkpoints'
        background writer, so the step pays the copy, never the
        serialization and fsync.  The first export also traces the
        program, here on the training thread (``ContinuousExporter.
        prime``); the exporter keeps it.  A failed write surfaces at the
        next export, as checkpoint writes do."""
        bundle = self.serving_bundle()
        if bundle is None or self._exporter is None:
            return
        with self.timing.timeit("servable_export"):
            serve, params, example = bundle
            version = self._version
            self._exporter.prime(serve, params, example)
            if self._ckpt_executor is None:
                self._ckpt_executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-write"
                )
            self._surface_export_errors(wait=True)
            tracing.event("worker.servable_export", version=version)
            self._export_future = self._ckpt_executor.submit(
                self._exporter.export, version, serve, params, example)
        self.timing.bump("servable_exports")

    def save_checkpoint(self):
        """Params AND optimizer state (``opt/``-prefixed): a restore must
        resume the momentum/Adam trajectory, not restart it.  Under
        ZeRO-1 the file holds the whole state in original shapes, so it
        moves between ZeRO-1 on and off.

        Called from outside the step cadence (a graceful preemption), a
        ZeRO-1 rank in a world of 2+ cannot gather its peers' shards:
        they are not in step with it.  It writes the parameters alone,
        and a restore restarts the moments, as a re-form without this
        rank's shard does."""
        if self._zero is not None and self._group() is not None:
            logger.warning(
                "zero1: a checkpoint outside the step cadence holds the "
                "parameters only (the optimizer shards of the other ranks "
                "are not gathered)")
            self._queue_checkpoint(None)
        else:
            self._queue_checkpoint(self._whole_state())

    def _queue_checkpoint(self, opt_whole):
        """Write the parameters and ``opt_whole`` (``_whole_state``'s, or
        None) at this version.  The device->host copy is synchronous (the
        next step updates the parameters in place); the disk write runs
        on a single background thread.  ``flush_checkpoints`` joins
        pending writes."""
        with self.timing.timeit("checkpoint_save"):
            payload = dict(self.export_parameters())
            if opt_whole is not None:
                layout = self._spec.to_jax_layout
                payload.update({
                    "opt/" + k: (layout(v) if isinstance(v, torch.Tensor)
                                 else v)
                    for k, v in opt_whole.items()})
            if self._ckpt_executor is None:
                self._ckpt_executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-write"
                )
            # Join the previous write first: bounds outstanding host
            # copies to one and makes its error (disk full) surface here.
            self._surface_checkpoint_errors(wait=True)
            self._ckpt_future = self._ckpt_executor.submit(
                self._checkpoint_saver.save, self._version, dense=payload
            )
        logger.info("checkpoint at version %d queued for write",
                    self._version)

    def zero1_report(self):
        """Per-device optimizer-state accounting (the JAX report's keys
        and numbers for the same model, optimizer and mesh): mode
        ``zero1`` or ``replicated`` in a world of 2+ ranks, None alone;
        ``num_shards`` is the size of ``dp``."""
        if self.process_count <= 1:
            return None
        if self._zero is None:
            total = self._partitioner(self._dp_size).state_bytes()[0]
            return {
                "mode": "replicated",
                "num_shards": self._dp_size,
                "per_device_bytes": int(total),
                "replicated_equiv_bytes": int(total),
                "reduction_factor": 1.0,
                "padding_bytes": 0,
                "scalar_leaves_replicated": 0,
            }
        replicated, sharded, padding = self._zero.state_bytes()
        return {
            "mode": "zero1",
            "num_shards": self._zero.num_shards,
            "per_device_bytes": int(sharded),
            "replicated_equiv_bytes": int(replicated),
            "reduction_factor": replicated / max(1, sharded),
            "padding_bytes": int(padding),
            "scalar_leaves_replicated": sum(
                1 for s in self._zero.state_specs if s.padded == 0),
        }

    def _log_zero1_placement(self):
        report = self.zero1_report()
        logger.info(
            "zero1: optimizer state sharded %d ways — %.3f MiB/device "
            "(replicated would be %.3f MiB/device, %.1fx reduction; "
            "%d padding bytes, %d scalar leaves replicated)",
            report["num_shards"],
            report["per_device_bytes"] / 2**20,
            report["replicated_equiv_bytes"] / 2**20,
            report["reduction_factor"],
            report["padding_bytes"],
            report["scalar_leaves_replicated"],
        )

    def close(self):
        """Join pending checkpoint writes (the worker calls this when
        its task loop ends)."""
        self.flush_checkpoints()

    def _surface_checkpoint_errors(self, wait):
        future = self._ckpt_future
        if future is None:
            return
        if wait or future.done():
            self._ckpt_future = None
            try:
                future.result()
            except Exception as e:  # noqa: BLE001 — IO errors
                raise RuntimeError(
                    "async checkpoint write failed: %s" % (e,)
                ) from e

    def _surface_export_errors(self, wait):
        future = self._export_future
        if future is None:
            return
        if wait or future.done():
            self._export_future = None
            try:
                future.result()
            except Exception as e:  # noqa: BLE001 — IO / trace errors
                raise RuntimeError(
                    "async servable export failed: %s" % (e,)
                ) from e

    def flush_checkpoints(self):
        """Join pending checkpoint and export writes and retire the
        writer thread; the next save recreates it."""
        try:
            self._surface_checkpoint_errors(wait=True)
            self._surface_export_errors(wait=True)
        finally:
            if self._ckpt_executor is not None:
                self._ckpt_executor.shutdown(wait=True)
                self._ckpt_executor = None

    def init_from_checkpoint(self):
        if self._checkpoint_saver is None:
            return False
        self.flush_checkpoints()
        try:
            dense, version = self._checkpoint_saver.load()
        except FileNotFoundError:
            return False
        params_named = {
            k: v for k, v in dense.items() if not k.startswith("opt/")
        }
        opt_named = {
            k[len("opt/"):]: v for k, v in dense.items()
            if k.startswith("opt/")
        }
        self._module.load_state_dict(
            self._spec.params_from_jax(params_named))
        self._load_whole_state(opt_named, self._spec.from_jax_layout)
        self._version = version
        logger.info("restored checkpoint version %d", version)
        return True
