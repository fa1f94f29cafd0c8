"""Nested-dict <-> flat named-dict bridges (counterpart of
``elasticdl_tpu/utils/pytree.py:19-42``).

JAX flattens a dict in sorted-key order and joins the path with ``/``;
a recursive walk over sorted keys gives the same names for flax param
dicts (``Bottleneck_3/Conv_1/kernel``), so checkpoints and exports name
their tensors identically in both packages.
"""

import numpy as np


def flatten_with_names(tree, prefix=""):
    """Nested dict of arrays -> ``{slash/joined/name: leaf}`` in JAX's
    leaf order.  (The JAX version also returns its treedef; a nested
    dict is its own structure, so this one returns the dict alone.)"""
    if not isinstance(tree, dict):
        return {prefix or "param": tree}
    named = {}
    for key in sorted(tree):
        name = "%s/%s" % (prefix, key) if prefix else str(key)
        named.update(flatten_with_names(tree[key], name))
    return named


def unflatten_from_names(tree_like, named, prefix=""):
    """Rebuild a nested dict shaped like ``tree_like`` from
    ``{slash/joined/name: array}``; each leaf takes the shape and dtype
    of its counterpart in ``tree_like``."""
    if not isinstance(tree_like, dict):
        name = prefix or "param"
        if name not in named:
            raise KeyError("missing parameter %s in restore data" % name)
        leaf = np.asarray(tree_like)
        return np.asarray(named[name]).reshape(leaf.shape).astype(
            leaf.dtype)
    return {
        key: unflatten_from_names(
            sub, named, "%s/%s" % (prefix, key) if prefix else str(key))
        for key, sub in tree_like.items()
    }
