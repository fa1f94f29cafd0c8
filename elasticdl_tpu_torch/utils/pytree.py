"""Nested-dict <-> flat named-dict bridges (counterpart of
``elasticdl_tpu/utils/pytree.py:19-42``), and the two tree walks the
trainer and the servable need for pytree features (``tree_leaves``,
``tree_map``; ``jax.tree_util``'s, for trees of dicts, lists and tuples).

JAX flattens a dict in sorted-key order and joins the path with ``/``;
a recursive walk over sorted keys gives the same names for flax param
dicts (``Bottleneck_3/Conv_1/kernel``), so checkpoints and exports name
their tensors identically in both packages.
"""


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples in JAX's order
    (a dict's keys sorted); anything else is a leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``, its structure kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub) for sub in tree)
    return fn(tree)

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
