"""Small shared utilities: shape and parameter-tree helpers.

Counterpart of ``analytics_zoo_tpu/common/utils.py``.  Parameter trees are
nested dicts and lists whose leaves are tensors (or quantized tensors);
``tree_map``/``tree_leaves`` stand in for ``jax.tree_util`` over them.
"""

from __future__ import annotations


def to_tuple_shape(shape) -> tuple:
    """Normalize a shape argument to a tuple of ints/None."""
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _tuple_like(tree, items):
    """``items`` as a tuple of ``tree``'s type (a named tuple stays one,
    as in ``jax.tree_util``)."""
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return _tuple_like(tree, [tree_map(fn, v) for v in tree])
    return fn(tree)


def tree_map_many(fn, tree, *rest):
    """``fn(leaf, *matching leaves)`` over trees of one structure, matched
    by key and index (not by visiting order, so dicts whose keys were
    inserted in different orders still pair up)."""
    if isinstance(tree, dict):
        return {k: tree_map_many(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_many(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else _tuple_like(tree, out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order ``tree_map`` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_structure(tree):
    """The tree's containers and keys with every leaf replaced by None —
    two trees with equal structures can be zipped leaf by leaf."""
    return tree_map(lambda _: None, tree)
