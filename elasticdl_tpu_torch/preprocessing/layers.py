"""Feature preprocessing, the elasticdl_preprocessing equivalent
(counterpart of ``elasticdl_tpu/preprocessing/layers.py``).

The reference ships 11 Keras layers (SURVEY.md §2.10,
elasticdl_preprocessing/layers/*). Here they are small callables with the
same names and semantics, built on numpy and torch:

 - host path (inside a zoo ``feed``): numpy in, numpy out — fast record
   munging before the batch crosses to the device;
 - device path: the numeric transforms (Discretization, Normalizer,
   RoundIdentity, LogRound, Hashing over ints, ConcatenateWithOffset,
   SparseEmbedding's combiners) take a ``torch.Tensor`` and answer with
   torch operations on its device, differentiable where the operation
   is.

Where this module differs from the JAX package's: ``_xp`` sends a
``torch.Tensor`` to torch and everything else to numpy (the JAX module
sends every non-numpy array to ``jax.numpy``).  Integer hashing on a
tensor runs splitmix64 in int64 arithmetic, whose multiply and xor wrap
as uint64's do and whose right shifts are masked to be logical, so its
ids equal numpy's uint64 ids bit for bit; strings still hash with sha256
on the host.

Ragged/sparse TF structures map to a single representation:
``RaggedBatch`` (flat values + row lengths) with ``to_dense`` producing the
static-shape padded array + mask that a device step wants.
"""

import hashlib

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def _xp(x):
    """torch for tensors, numpy for everything else."""
    return torch if isinstance(x, torch.Tensor) else np


def _signed64(value):
    """A uint64 constant as the int64 with the same bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >> 63 else value


def _srl(z, k):
    """Logical right shift of an int64 tensor read as uint64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _umod(z, n):
    """``z mod n`` with the int64 tensor ``z`` read as uint64."""
    low = (z & _MASK63) % n
    high = (z < 0).to(torch.int64) * ((1 << 63) % n)
    return (low + high) % n


class RaggedBatch:
    """Variable-length rows: flat values + per-row lengths.

    The stand-in for tf.RaggedTensor/SparseTensor (ToRagged / ToSparse
    below build it); ``to_dense`` yields [batch, max_len] + float mask
    for static-shape device code.
    """

    def __init__(self, values, row_lengths):
        self.values = np.asarray(values)
        self.row_lengths = np.asarray(row_lengths, dtype=np.int64)

    @classmethod
    def from_rows(cls, rows):
        rows = [np.asarray(r) for r in rows]
        lengths = [r.size for r in rows]
        values = (
            np.concatenate([r.reshape(-1) for r in rows])
            if rows else np.zeros((0,))
        )
        return cls(values, lengths)

    def rows(self):
        out = []
        start = 0
        for n in self.row_lengths:
            out.append(self.values[start:start + n])
            start += n
        return out

    def to_dense(self, max_len=None, padding_value=0):
        max_len = max_len or (
            int(self.row_lengths.max()) if len(self.row_lengths) else 0
        )
        dense = np.full(
            (len(self.row_lengths), max_len), padding_value,
            dtype=self.values.dtype,
        )
        mask = np.zeros((len(self.row_lengths), max_len), np.float32)
        start = 0
        for i, n in enumerate(self.row_lengths):
            k = min(int(n), max_len)
            dense[i, :k] = self.values[start:start + k]
            mask[i, :k] = 1.0
            start += n
        return dense, mask

    def map_values(self, fn):
        return RaggedBatch(fn(self.values), self.row_lengths)


def _apply(inputs, fn):
    if isinstance(inputs, RaggedBatch):
        return inputs.map_values(fn)
    return fn(inputs)


class Discretization:
    """Bucketize by boundaries; output in [0, len(bins)]
    (reference: layers/discretization.py:20)."""

    def __init__(self, bin_boundaries):
        self.bin_boundaries = np.asarray(bin_boundaries, np.float64)

    def __call__(self, inputs):
        def fn(x):
            if isinstance(x, torch.Tensor):
                # right=True is np.digitize's bins[i-1] <= x < bins[i].
                bounds = torch.as_tensor(self.bin_boundaries,
                                         device=x.device)
                return torch.bucketize(x.to(torch.float64), bounds,
                                       right=True)
            return np.digitize(np.asarray(x, np.float64),
                               self.bin_boundaries).astype(np.int64)
        return _apply(inputs, fn)


class Hashing:
    """Deterministic hash to [0, num_bins)
    (reference: layers/hashing.py:19).  Integers use a splitmix64 mix
    (numpy uint64 on the host, int64 torch ops on a tensor, the same
    ids); strings, bytes and floats hash via sha256 on the host."""

    def __init__(self, num_bins, salt=0):
        self.num_bins = num_bins
        self.salt = salt

    def _hash_int_array(self, x):
        if isinstance(x, torch.Tensor):
            z = x.to(torch.int64) + _signed64(0x9E3779B97F4A7C15 + self.salt)
            z = (z ^ _srl(z, 30)) * _signed64(0xBF58476D1CE4E5B9)
            z = (z ^ _srl(z, 27)) * _signed64(0x94D049BB133111EB)
            z = z ^ _srl(z, 31)
            return _umod(z, self.num_bins)
        z = np.asarray(x).astype(np.uint64) + np.uint64(
            0x9E3779B97F4A7C15 + self.salt
        )
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        return (z % np.uint64(self.num_bins)).astype(np.int64)

    def _hash_one(self, value):
        data = str(value).encode("utf-8") + str(self.salt).encode()
        return int(hashlib.sha256(data).hexdigest(), 16) % self.num_bins

    def __call__(self, inputs):
        def fn(x):
            if isinstance(x, torch.Tensor):
                if not (x.is_floating_point() or x.is_complex()):
                    return self._hash_int_array(x)
                # Other values hash their strings on the host, as the JAX
                # package hashes a float device array's.
                x = x.detach().cpu().numpy()
            arr = np.asarray(x) if isinstance(
                x, (np.ndarray, list, tuple)
            ) else x
            if hasattr(arr, "dtype") and np.issubdtype(
                np.asarray(arr).dtype if isinstance(arr, np.ndarray)
                else arr.dtype, np.integer
            ):
                return self._hash_int_array(arr)
            flat = np.asarray(arr).reshape(-1)
            out = np.array([self._hash_one(v) for v in flat], np.int64)
            return out.reshape(np.shape(arr))
        return _apply(inputs, fn)


class IndexLookup:
    """Vocabulary lookup; OOV maps to len(vocab)
    (reference: layers/index_lookup.py:22)."""

    def __init__(self, vocabulary):
        self.vocabulary = list(vocabulary)
        self._table = {v: i for i, v in enumerate(self.vocabulary)}
        self.oov_index = len(self.vocabulary)

    def __call__(self, inputs):
        def fn(x):
            flat = np.asarray(x, dtype=object).reshape(-1)
            out = np.array(
                [self._table.get(
                    v.decode() if isinstance(v, bytes) else str(v),
                    self.oov_index,
                ) for v in flat],
                np.int64,
            )
            return out.reshape(np.shape(x))
        return _apply(inputs, fn)

    def vocab_size(self):
        return len(self.vocabulary) + 1  # + OOV


class LogRound:
    """round(log_base(x)) clipped to [0, num_bins)
    (reference: layers/log_round.py:29).  A tensor is computed in
    float32, as the JAX package computes a device array."""

    def __init__(self, num_bins, base=None, default_value=0):
        self.num_bins = num_bins
        self.base = base or np.e
        self.default_value = default_value

    def __call__(self, inputs):
        def fn(x):
            xp = _xp(x)
            if xp is np:
                x = np.asarray(x, np.float64)
                ones = 1.0
            else:
                x = x.to(torch.float32)
                ones = torch.ones_like(x)
            safe = xp.where(x > 0, x, ones)
            out = xp.round(xp.log(safe) / float(np.log(self.base)))
            out = xp.where(x > 0, out, self.default_value * ones)
            out = xp.clip(out, 0, self.num_bins - 1)
            return out.to(torch.int64) if xp is torch else \
                out.astype(np.int64)
        return _apply(inputs, fn)


class Normalizer:
    """(x - subtract) / divide (reference: layers/normalizer.py:17)."""

    def __init__(self, subtract=0.0, divide=1.0):
        self.subtract = subtract
        self.divide = divide

    def __call__(self, inputs):
        return _apply(
            inputs,
            lambda x: (_xp(x).asarray(x) - self.subtract) / self.divide,
        )


class RoundIdentity:
    """round(x) clipped to [0, num_buckets)
    (reference: layers/round_identity.py:18)."""

    def __init__(self, num_buckets, default_value=0):
        self.num_buckets = num_buckets
        self.default_value = default_value

    def __call__(self, inputs):
        def fn(x):
            xp = _xp(x)
            out = xp.clip(xp.round(xp.asarray(x)), 0, self.num_buckets - 1)
            return out.to(torch.int64) if xp is torch else \
                out.astype(np.int64)
        return _apply(inputs, fn)


class ToNumber:
    """Parse strings to numbers; empty/invalid -> default
    (reference: layers/to_number.py:33)."""

    def __init__(self, out_type=np.float32, default_value=0):
        self.out_type = out_type
        self.default_value = default_value

    def __call__(self, inputs):
        def one(v):
            if isinstance(v, bytes):
                v = v.decode()
            try:
                return self.out_type(v)
            except (TypeError, ValueError):
                return self.out_type(self.default_value)

        def fn(x):
            flat = np.asarray(x, dtype=object).reshape(-1)
            out = np.array([one(v) for v in flat], dtype=self.out_type)
            return out.reshape(np.shape(x))
        return _apply(inputs, fn)


class ToRagged:
    """Split delimiter-joined strings (or take per-row lists) into a
    RaggedBatch (reference: layers/to_ragged.py:19)."""

    def __init__(self, sep=",", ignore_value=""):
        self.sep = sep
        self.ignore_value = ignore_value

    def __call__(self, inputs):
        rows = []
        for item in inputs:
            if isinstance(item, bytes):
                item = item.decode()
            if isinstance(item, str):
                parts = [
                    p for p in item.split(self.sep)
                    if p != self.ignore_value
                ]
                rows.append(np.asarray(parts, dtype=object))
            else:
                rows.append(np.asarray(item))
        return RaggedBatch.from_rows(rows)


class ToSparse:
    """Alias view: same RaggedBatch representation; kept for API parity
    (reference: layers/to_sparse.py:17)."""

    def __init__(self, ignore_value=""):
        self.ignore_value = ignore_value

    def __call__(self, inputs):
        if isinstance(inputs, RaggedBatch):
            return inputs
        return ToRagged(ignore_value=self.ignore_value)(inputs)


class ConcatenateWithOffset:
    """Add per-tensor offsets then concatenate
    (reference: layers/concatenate_with_offset.py:17)."""

    def __init__(self, offsets, axis=-1):
        self.offsets = offsets
        self.axis = axis

    def __call__(self, inputs):
        if len(inputs) != len(self.offsets):
            raise ValueError(
                "%d inputs vs %d offsets"
                % (len(inputs), len(self.offsets))
            )
        if isinstance(inputs[0], RaggedBatch):
            shifted = [
                rb.map_values(lambda v, o=o: np.asarray(v) + o)
                for rb, o in zip(inputs, self.offsets)
            ]
            rows_per_input = [rb.rows() for rb in shifted]
            merged = [
                np.concatenate([rows[i] for rows in rows_per_input])
                for i in range(len(rows_per_input[0]))
            ]
            return RaggedBatch.from_rows(merged)
        if isinstance(inputs[0], torch.Tensor):
            return torch.cat([torch.as_tensor(x) + o
                              for x, o in zip(inputs, self.offsets)],
                             dim=self.axis)
        return np.concatenate(
            [np.asarray(x) + o for x, o in zip(inputs, self.offsets)],
            axis=self.axis)


class SparseEmbedding:
    """Combiner over embedding rows of padded ids with a mask — the
    device half of the reference's SparseEmbedding layer
    (layers/sparse_embedding.py:20).  Torch operations, differentiable,
    on tensors; numpy on host arrays.

    rows: [B, L, dim] gathered embeddings; mask: [B, L].
    combiner: sum | mean | sqrtn
    """

    def __init__(self, combiner="mean"):
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("unknown combiner %r" % combiner)
        self.combiner = combiner

    def __call__(self, rows, mask):
        if isinstance(rows, torch.Tensor):
            mask = torch.as_tensor(mask, device=rows.device).to(
                rows.dtype)[..., None]
            total = (rows * mask).sum(dim=1)
            count = mask.sum(dim=1).clamp(min=1e-9)
            sqrt = torch.sqrt
        else:
            mask = np.asarray(mask)[..., None]
            total = (np.asarray(rows) * mask).sum(axis=1)
            count = np.maximum(mask.sum(axis=1), 1e-9)
            sqrt = np.sqrt
        if self.combiner == "sum":
            return total
        if self.combiner == "mean":
            return total / count
        return total / sqrt(count)
