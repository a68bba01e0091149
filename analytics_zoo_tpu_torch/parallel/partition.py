"""Leaf paths of the port's parameter trees, for rule matching.

Counterpart of the path half of ``analytics_zoo_tpu/parallel/partition.py``:
a leaf's name is its dict keys and list indices joined with ``/``, as
``leaf_path_name`` renders a JAX tree path there, so a rule regex hits the
same leaves in both packages (``{"a": [{"w": ...}]}`` names its leaf
``a/0/w``).  :func:`match_rule_values` maps a first-match rule table over
those names to values (a plan's ``dtype_rules`` to dtype roles).  The
sharding half (PartitionSpecs over a mesh) waits for the distribution
slice (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import math
import re


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


def match_rule_values(rules, tree, *, default=None, skip_scalars=True):
    """First-match ``(regex, value)`` table over leaf paths: a tree of the
    same structure holding each leaf's value.  An unmatched leaf gets
    ``default`` (a value table is an overlay, not a layout that must cover
    the tree); with ``skip_scalars``, scalar and size-1 leaves keep
    ``default`` too, so a catch-all rule never narrows a loss scale or a
    step count."""
    rules = [(str(pat), val) for pat, val in rules]

    def value_for(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if skip_scalars and math.prod(shape) == 1:
            return default
        name = leaf_path_name(path)
        for pattern, val in rules:
            if re.search(pattern, name):
                return val
        return default

    return tree_map_with_path(value_for, tree)
