"""ZeRO-1 weight-update sharding: the flat padded full-coverage layout
(counterpart of ``elasticdl_tpu/worker/zero.py``).

Every rank of a data-parallel world applies the same weight update to the
same replicated parameters; ZeRO-1 shards the optimizer state and the
update over the ranks instead, so each holds ~1/N of the state.  Every
non-scalar leaf is flattened to 1-D (in its logical element order) and
padded with zeros to a multiple of the shard count, and rank r owns the
r-th 1/N of it, whatever the leaf's shape:

    leaf [64, 32, 3, 3] -> flat [18432] -> pad [18432] -> 8 x [2304]
    leaf [10]           -> flat [10]    -> pad [16]    -> 8 x [2]

A rank-0 leaf (Adam's step count) stays whole on every rank
(``padded == 0``).  With a zero gradient and zero moments the padded
tail gets an exactly-zero update under SGD momentum, Adam and AdamW, so
it never reaches a real element, and ``unflatten_*`` is the unpadding
view: checkpoints always hold original shapes and move between ZeRO-1
on and off.

This module is the geometry and the tensor bookkeeping only.  The JAX
partitioner's shardings, ``place_state``, ``gather_to_host`` and
``repartition`` are device placements of one SPMD program; here each
rank is a process, so they become plain tensor functions (``cut``: a
full tensor -> rank r's shard; ``assemble_state``: every rank's shards
-> full shapes), and the collectives that move shards between ranks are
the trainer's (``worker/collective_trainer.py``) through
``parallel/transport.py``.

The state leaves are counted in the JAX layout: one step count per
optimizer (per LoRA group) and the slots named as the trainer's
``_opt_state_to_jax`` names them, not torch's per-parameter ``step``
tensors, so ``state_bytes`` reads the JAX partitioner's numbers for the
same model, optimizer and N.
"""

import numpy as np
import torch


class _LeafSpec:
    """Flat-form geometry of one leaf: original shape, element count and
    padded (shard-divisible) length.  ``padded == 0`` marks a scalar
    (rank-0) leaf that stays whole on every rank."""

    __slots__ = ("shape", "size", "padded")

    def __init__(self, shape, num_shards):
        self.shape = tuple(shape)
        if self.shape:
            self.size = int(np.prod(self.shape))
            self.padded = -(-self.size // num_shards) * num_shards
        else:  # scalar: nothing to shard
            self.size = 1
            self.padded = 0


def _itemsize(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


class ZeroPartitioner:
    """The flat padded ZeRO-1 layout of one world: ``num_shards`` ranks,
    this one ``rank``.

    ``params``: ``[(name, shape, dtype)]`` of the parameters the
    optimizer updates; ``state``: the same for each optimizer-state leaf
    in the JAX layout (a scalar count has shape ``()``).  Shapes and
    dtypes only, so a partitioner costs no memory."""

    def __init__(self, params, state, num_shards, rank=0):
        if not 0 <= rank < num_shards:
            raise ValueError("rank %d of %d shards" % (rank, num_shards))
        self.num_shards = int(num_shards)
        self.rank = int(rank)
        self.param_names = [name for name, _, _ in params]
        self.param_specs = [_LeafSpec(shape, num_shards)
                            for _, shape, _ in params]
        self.param_dtypes = [dtype for _, _, dtype in params]
        self.state_names = [name for name, _, _ in state]
        self.state_specs = [_LeafSpec(shape, num_shards)
                            for _, shape, _ in state]
        self.state_dtypes = [dtype for _, _, dtype in state]
        self._state_index = {name: i for i, name in
                             enumerate(self.state_names)}

    # -- one leaf ------------------------------------------------------------

    def shard_len(self, spec):
        """Elements of one rank's shard of a leaf (0 for a scalar)."""
        return spec.padded // self.num_shards

    @staticmethod
    def flatten_leaf(t, spec):
        """A leaf in original shape -> 1-D, zero-padded to ``padded``
        (a scalar leaf as it is)."""
        if spec.padded == 0:
            return t
        flat = t.reshape(-1)
        if spec.padded != spec.size:
            flat = torch.cat([flat, flat.new_zeros(spec.padded - spec.size)])
        return flat

    @staticmethod
    def unflatten_leaf(flat, spec):
        """1-D padded -> original shape (the unpadding view)."""
        if spec.padded == 0:
            return flat
        return flat[:spec.size].reshape(spec.shape)

    def cut(self, t, spec, rank=None):
        """Rank ``rank``'s (default: this one's) shard of a leaf in
        original shape, as a tensor of its own; a scalar leaf whole."""
        if spec.padded == 0:
            return t.clone() if isinstance(t, torch.Tensor) else t
        r = self.rank if rank is None else rank
        n = self.shard_len(spec)
        flat = t.reshape(-1)
        lo, hi = r * n, min((r + 1) * n, spec.size)
        shard = flat.new_zeros(n)
        if hi > lo:
            shard[:hi - lo] = flat[lo:hi]
        return shard

    # -- trees ---------------------------------------------------------------

    def _check(self, leaves, specs, what):
        if len(leaves) != len(specs):
            raise ValueError(
                "%s has %d leaves but the partitioner was built for %d "
                "(optimizer changed since it was built?)"
                % (what, len(leaves), len(specs)))

    def flatten_params(self, leaves):
        """Parameters (or gradients) in original shapes, in
        ``param_names`` order -> flat padded."""
        self._check(leaves, self.param_specs, "the parameter list")
        return [self.flatten_leaf(t, s)
                for t, s in zip(leaves, self.param_specs)]

    def unflatten_params(self, flats):
        """Flat padded parameters -> original shapes."""
        self._check(flats, self.param_specs, "the parameter list")
        return [self.unflatten_leaf(f, s)
                for f, s in zip(flats, self.param_specs)]

    def _state_items(self, state):
        self._check(list(state), self.state_specs, "the optimizer state")
        return [(name, state[name],
                 self.state_specs[self._state_index[name]])
                for name in self.state_names]

    def flatten_state(self, state):
        """``{name: leaf}`` in original shapes -> flat padded."""
        return {name: self.flatten_leaf(v, s)
                for name, v, s in self._state_items(state)}

    def unflatten_state(self, flat):
        """Flat padded ``{name: leaf}`` -> original shapes."""
        return {name: self.unflatten_leaf(v, s)
                for name, v, s in self._state_items(flat)}

    def cut_state(self, state, rank=None):
        """``{name: leaf}`` in original shapes -> rank ``rank``'s shard of
        each (scalars whole)."""
        return {name: self.cut(v, s, rank)
                for name, v, s in self._state_items(state)}

    def assemble_state(self, shards):
        """Every rank's ``cut_state``, in rank order -> the full state in
        original shapes; scalars are rank 0's."""
        if len(shards) != self.num_shards:
            raise ValueError("%d shards for a layout of %d"
                             % (len(shards), self.num_shards))
        out = {}
        for name, spec in zip(self.state_names, self.state_specs):
            if spec.padded == 0:
                out[name] = shards[0][name]
            else:
                out[name] = self.unflatten_leaf(
                    torch.cat([s[name] for s in shards]), spec)
        return out

    # -- byte accounting -----------------------------------------------------

    def state_bytes(self):
        """(replicated_equivalent, per_device_sharded, padding) bytes of
        the optimizer state: what every rank would hold without ZeRO-1,
        what one rank holds now (padded/N of each sharded leaf, scalars
        whole) and the bytes spent on padding over all ranks."""
        replicated = sharded = padding = 0
        for spec, dtype in zip(self.state_specs, self.state_dtypes):
            itemsize = _itemsize(dtype)
            replicated += spec.size * itemsize
            if spec.padded:
                sharded += spec.padded // self.num_shards * itemsize
                padding += (spec.padded - spec.size) * itemsize
            else:
                sharded += spec.size * itemsize
        return replicated, sharded, padding

    def flat_param_bytes(self):
        """Bytes of one flat padded parameter (or gradient) list: the
        logical payload of a step's gradient reduction and parameter
        all-gather."""
        return sum((spec.padded or spec.size) * _itemsize(dtype)
                   for spec, dtype in zip(self.param_specs,
                                          self.param_dtypes))
