"""Collective trainer, single process (counterpart of
``elasticdl_tpu/worker/collective_trainer.py``).

One process, one device, no mesh: this is the trainer that the JAX
package's ``bench.py`` and its trainer tests drive.  What it keeps of the
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

Left for later slices: meshes and ``rebuild`` (elastic collectives,
ROADMAP A4), ZeRO-1 (A6) and the servable exporter (A11); the
constructor's ``mesh``, ``zero1`` and ``exporter`` accept only their
defaults and otherwise raise ``NotImplementedError`` naming the item.
"""

import concurrent.futures

import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.utils.args import not_ported
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.pytree import tree_leaves, tree_map
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.fused_driver import (
    PreparedBatch,
    StagedWindow,
)
from elasticdl_tpu_torch.worker.trainer import Trainer

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


def _opt_state_to_jax(optimizer, named_params, to_jax_layout):
    """A torch optimizer's state -> ``{name: ndarray}`` as
    ``flatten_with_names`` names the optax state it stands for, each slot
    in its parameter's JAX layout.  A slot not created yet (before the
    first step) is saved as optax's initial value: zeros."""
    def slot(state, key, p):
        value = state.get(key)
        return to_jax_layout(value if value is not None
                             else torch.zeros_like(p))

    out = {}
    if isinstance(optimizer, torch.optim.SGD):
        if not optimizer.defaults["momentum"]:
            return out
        for prefix, name, p in _grouped(optimizer, named_params):
            out[prefix + "0/trace/" + name] = slot(
                optimizer.state.get(p, {}), "momentum_buffer", p)
        return out
    if isinstance(optimizer, _ADAM):
        # Every group steps together, so each optax count is the step.
        count = max((int(s["step"]) for s in optimizer.state.values()
                     if "step" in s), default=0)
        for group in optimizer.param_groups:
            out[group.get("jax_prefix", "") + "0/count"] = np.asarray(
                count, np.int32)
        for prefix, name, p in _grouped(optimizer, named_params):
            state = optimizer.state.get(p, {})
            out[prefix + "0/mu/" + name] = slot(state, "exp_avg", p)
            out[prefix + "0/nu/" + name] = slot(state, "exp_avg_sq", p)
        return out
    raise NotImplementedError(
        "no checkpoint mapping for optimizer %s" % type(optimizer).__name__)


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
    ):
        if mesh is not None:
            raise not_ported("a CollectiveTrainer over a mesh", "A4")
        if zero1:
            raise not_ported("ZeRO-1 (zero1=True)", "A6")
        if exporter is not None or export_steps:
            raise not_ported("continuous servable export", "A11")
        self._spec = spec
        self._batch_size = batch_size
        self._accum_steps = accum_steps
        self._mc = master_client
        self._report_version_steps = report_version_steps
        self._checkpoint_saver = checkpoint_saver
        self._checkpoint_steps = checkpoint_steps
        self._use_bf16_compute = use_bf16_compute
        self._device = resolve_device(device)
        self.timing = Timing(logger=logger)
        self._version = 0
        self._ckpt_executor = None
        self._ckpt_future = None
        self._module = spec.init_fn(self._device, rng_seed)
        self._optimizer = self._new_optimizer()

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

    def _loss_and_grads(self, features, labels, weights):
        """Forward and backward of one (micro)batch; the gradients add
        into ``.grad``.  Returns the masked-mean loss, detached."""
        with torch.autocast(self._device.type, dtype=torch.bfloat16,
                            enabled=self._use_bf16_compute):
            out = self._spec.apply_fn(self._module, features, True)
        per_example = self._spec.loss_fn(out, labels).float()
        loss = _masked_mean(per_example, weights)
        loss.backward()
        return loss.detach()

    def _train_step(self, features, labels, weights):
        self._module.train()
        self._optimizer.zero_grad(set_to_none=True)
        accum = self._accum_steps
        if accum == 1:
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
        self._optimizer.step()
        return loss

    # -- Trainer API --------------------------------------------------------

    def prepare_batch(self, features, labels, count=None):
        """Host-side batch prep: pad to the static batch (with the loss
        mask) and reshape for accumulation, on CPU tensors.  It touches
        no device, so it may run on the prefetch producer thread; the
        step's thread copies the result to the card."""
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
        """None: windows are unbounded (one process, no mesh)."""
        return None

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
        if self._checkpoint_saver is not None and self._checkpoint_steps:
            dists.append(
                self._checkpoint_steps
                - self._version % self._checkpoint_steps
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
            self.save_checkpoint()

    def _forward(self, features):
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
        self._optimizer = self._new_optimizer()

    def export_parameters(self):
        """``{JAX name: ndarray}`` in the JAX layouts (host copies)."""
        return self._spec.params_to_jax(self._module)

    def save_checkpoint(self):
        """Params AND optimizer state (``opt/``-prefixed): a restore must
        resume the momentum/Adam trajectory, not restart it.

        The device->host copy is synchronous (the next step updates the
        parameters in place); the disk write runs on a single background
        thread.  ``flush_checkpoints`` joins pending writes."""
        with self.timing.timeit("checkpoint_save"):
            payload = dict(self.export_parameters())
            opt_named = _opt_state_to_jax(self._optimizer,
                                          self._named_params(),
                                          self._spec.to_jax_layout)
            payload.update({"opt/" + k: v for k, v in opt_named.items()})
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
        """Per-device optimizer-state accounting of ZeRO-1: None, as in
        the JAX trainer without a mesh (ZeRO-1 is ROADMAP A6)."""
        return None

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

    def flush_checkpoints(self):
        """Join pending checkpoint writes and retire the writer thread;
        the next save recreates it."""
        try:
            self._surface_checkpoint_errors(wait=True)
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
        self.set_params(self._spec.params_from_jax(params_named))
        if opt_named:
            try:
                _opt_state_from_jax(self._optimizer, self._named_params(),
                                    opt_named, self._spec.from_jax_layout)
            except (KeyError, ValueError) as e:
                # Optimizer changed since the checkpoint (e.g. Adam ->
                # momentum): params are still good, trajectory is not.
                logger.warning(
                    "checkpoint optimizer state incompatible (%s); "
                    "re-initializing optimizer", e,
                )
                self._optimizer = self._new_optimizer()
        self._version = version
        logger.info("restored checkpoint version %d", version)
        return True
