"""Declarative feature columns over the preprocessing layers.

Numpy-first counterpart of the reference's feature-column helpers
(elasticdl_preprocessing/feature_column/feature_column.py — notably
``concatenated_categorical_column``, which merges many categorical
columns into ONE offset id space so a single PS-served embedding table
backs them all: one big table beats per-column tables on both model
size and PS traffic).

Columns declare the record-dict -> model-input mapping; ``make_feed``
compiles a set of columns into the framework's feed convention
({"dense": [B, Dn], "__ids__": {table: [B, F]}}, labels) consumed by
the PS trainer's embedding machinery (worker/ps_trainer.py).

Dataset-statistics plumbing: ``*.from_stats`` constructors read the
analyzer's env-exported statistics (preprocessing/analyzer_utils.py, the
reference's ``_ELASTICDL_*`` scheme) so a feed can be configured
entirely by an offline analyzer job.
"""

import numpy as np

from elasticdl_tpu_torch.preprocessing import analyzer_utils
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    IndexLookup,
    Normalizer,
)


class FeatureColumn:
    """Base: a named transform from raw column values to arrays."""

    def __init__(self, key):
        self.key = key

    def transform(self, values):
        raise NotImplementedError


def _to_floats(values, default):
    """Float coercion with missing-value default (shared by numeric and
    bucketized columns)."""
    return np.asarray(
        [default if v in ("", None) else float(v) for v in values],
        np.float32,
    )


class NumericColumn(FeatureColumn):
    """Float feature, optionally normalized."""

    def __init__(self, key, normalizer_fn=None, default=0.0):
        super().__init__(key)
        self._normalizer = normalizer_fn
        self._default = default

    @classmethod
    def from_stats(cls, key, default=0.0):
        """Standardize with the analyzer's mean/stddev for this key."""
        mean = analyzer_utils.get_mean(key, 0.0)
        std = analyzer_utils.get_stddev(key, 1.0) or 1.0
        return cls(key, Normalizer(subtract=mean, divide=std),
                   default=default)

    def transform(self, values):
        arr = _to_floats(values, self._default)
        if self._normalizer is not None:
            arr = np.asarray(self._normalizer(arr), np.float32)
        return arr


class CategoricalColumn(FeatureColumn):
    """Base for id-producing columns; exposes ``num_buckets``."""

    num_buckets = None


class CategoricalIdentityColumn(CategoricalColumn):
    def __init__(self, key, num_buckets, default=0):
        super().__init__(key)
        self.num_buckets = num_buckets
        self._default = default

    def transform(self, values):
        ids = np.asarray(
            [self._default if v in ("", None) else int(v)
             for v in values],
            np.int64,
        )
        return np.clip(ids, 0, self.num_buckets - 1)


class CategoricalVocabColumn(CategoricalColumn):
    """Vocabulary lookup; OOV maps past the vocab (reference
    IndexLookup semantics)."""

    def __init__(self, key, vocabulary):
        super().__init__(key)
        self._lookup = IndexLookup(list(vocabulary))
        self.num_buckets = self._lookup.vocab_size()  # vocab + OOV

    @classmethod
    def from_stats(cls, key):
        vocab = analyzer_utils.get_vocabulary(key)
        if vocab is None:
            raise ValueError(
                "no analyzer vocabulary exported for %r" % key
            )
        return cls(key, vocab)

    def transform(self, values):
        # IndexLookup handles bytes/str/other renditions itself.
        return np.asarray(self._lookup(list(values)), np.int64)


class CategoricalHashColumn(CategoricalColumn):
    def __init__(self, key, hash_bucket_size):
        super().__init__(key)
        self._hashing = Hashing(hash_bucket_size)
        self.num_buckets = hash_bucket_size

    def transform(self, values):
        # Hashing dispatches by dtype (vectorized splitmix64 for ints,
        # sha256 for strings) — don't force everything through str().
        return np.asarray(self._hashing(np.asarray(values)), np.int64)


class BucketizedColumn(CategoricalColumn):
    """Numeric feature discretized into bucket ids."""

    def __init__(self, key, boundaries, default=0.0):
        super().__init__(key)
        self._disc = Discretization(list(boundaries))
        self._default = default
        self.num_buckets = len(boundaries) + 1

    @classmethod
    def from_stats(cls, key, default=0.0):
        bounds = analyzer_utils.get_bucket_boundaries(key)
        if bounds is None:
            raise ValueError(
                "no analyzer bucket boundaries exported for %r" % key
            )
        return cls(key, bounds, default=default)

    def transform(self, values):
        return np.asarray(
            self._disc(_to_floats(values, self._default)), np.int64
        )


class ConcatenatedCategoricalColumn(CategoricalColumn):
    """Merge categorical columns into one offset id space
    (reference feature_column.py concatenated_categorical_column): the
    id range becomes [0, sum of num_buckets), each source column offset
    by the buckets before it, so ONE embedding table serves all of
    them."""

    def __init__(self, columns):
        if not columns:
            raise ValueError("need at least one categorical column")
        for c in columns:
            if not isinstance(c, CategoricalColumn):
                raise ValueError(
                    "%r is not a CategoricalColumn" % (c,)
                )
            if isinstance(c, ConcatenatedCategoricalColumn):
                raise ValueError(
                    "cannot nest concatenated columns; pass the leaf "
                    "columns in one flat list"
                )
        super().__init__("+".join(c.key for c in columns))
        self.columns = list(columns)
        self.offsets = np.concatenate(
            [[0], np.cumsum([c.num_buckets for c in columns])[:-1]]
        ).astype(np.int64)
        self.num_buckets = int(sum(c.num_buckets for c in columns))

    def transform(self, record_columns):
        """record_columns: {key: [B] raw values} -> [B, F] int64 ids."""
        cols = [
            c.transform(record_columns[c.key]) + off
            for c, off in zip(self.columns, self.offsets)
        ]
        return np.stack(cols, axis=1)


def concatenated_categorical_column(columns):
    return ConcatenatedCategoricalColumn(columns)


def make_feed(numeric_columns, id_tables, label_key="label",
              label_dtype=np.int32, column_order=None):
    """Compile columns into the framework feed convention.

    numeric_columns: [NumericColumn] -> "dense" [B, Dn].
    id_tables: {table_name: ConcatenatedCategoricalColumn} -> "__ids__"
        entries, one per PS embedding table.
    Records arrive as a dict of columns ({key: [B] values}), a list of
    per-record dicts, or — when ``column_order`` names the positions —
    a list of per-record sequences (the row shape of the SQL and CSV
    readers).
    """

    def feed(records):
        if isinstance(records, list):
            first = records[0]
            if isinstance(first, dict):
                columns = {k: [r[k] for r in records] for k in first}
            else:
                if column_order is None:
                    raise ValueError(
                        "list-shaped records need column_order"
                    )
                columns = {
                    k: [r[i] for r in records]
                    for i, k in enumerate(column_order)
                }
        else:
            columns = records
        out = {}
        if numeric_columns:
            out["dense"] = np.stack(
                [c.transform(columns[c.key]) for c in numeric_columns],
                axis=1,
            )
        # Several tables may share one concat column (e.g. a wide and a
        # deep embedding over the same id space) — transform each
        # distinct column once per batch.
        cache = {}
        out["__ids__"] = {}
        for table, concat in id_tables.items():
            if id(concat) not in cache:
                cache[id(concat)] = concat.transform(columns)
            out["__ids__"][table] = cache[id(concat)]
        labels = np.asarray(columns[label_key], label_dtype)
        return out, labels

    return feed
