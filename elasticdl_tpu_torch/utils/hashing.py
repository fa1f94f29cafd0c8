"""Stable partition routing.

Dense parameters route to a PS shard by name hash; embedding ids route by
``id % n``.  Same contract as the reference
(elasticdl/python/common/hash_utils.py:17-62,
elasticdl/go/pkg/ps/checkpoint.go:31-39) so checkpoints written by any shard
count N can be re-routed deterministically.
"""

import hashlib

import numpy as np


def string_to_id(name, num_partitions):
    h = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(h, 16) % num_partitions


def int_to_id(value, num_partitions):
    return int(value) % num_partitions


def scatter_ids(ids, num_partitions):
    """Group a sequence of embedding ids by owning partition.

    Returns {partition: positions ndarray} so callers can gather results
    back into the original order.  Vectorized — this sits on the PS
    pull/push hot path, called once per table per minibatch.
    """
    ids = np.asarray(ids, dtype=np.int64)
    owners = ids % num_partitions
    return {
        int(p): np.flatnonzero(owners == p)
        for p in np.unique(owners)
    }
