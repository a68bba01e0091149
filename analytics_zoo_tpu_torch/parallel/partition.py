"""Leaf paths of the port's parameter trees, for rule matching.

Counterpart of the path half of ``analytics_zoo_tpu/parallel/partition.py``:
a leaf's name is its dict keys and list indices joined with ``/``, as
``leaf_path_name`` renders a JAX tree path there, so a rule regex hits the
same leaves in both packages (``{"a": [{"w": ...}]}`` names its leaf
``a/0/w``).  The sharding half (PartitionSpecs over a mesh) waits for the
distribution slice (ROADMAP queue 1 item 13).
"""

from __future__ import annotations


def leaf_path_name(path) -> str:
    """A path (the keys and indices from the root to a leaf) as a
    ``/``-joined name."""
    return "/".join(str(k) for k in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf of a nested dict/list/tuple tree;
    the same structure back."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)
