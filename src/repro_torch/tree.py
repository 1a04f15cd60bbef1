"""Nested-container helpers for parameter trees (dicts, lists, tuples).

The port keeps parameters as plain nested dicts of tensors, like the
reference keeps pytrees.  Leaf order follows the reference's tree
flattening — dict keys sorted, lists and tuples in order, `None` an empty
subtree — so a `FlatLayout` built from the same tree packs the same leaves
into the same slots in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TreeDef:
    """Hashable structure of a tree: nested ("dict", keys, children),
    ("list" | "tuple", children), ("none",) and ("leaf",) nodes."""
    node: tuple


# The walks below are module-level functions, not closures that call
# themselves: such a closure is a reference cycle, which would keep the
# leaves it collected (GBs of activations and gradients) alive until the
# cyclic garbage collector ran, instead of until their last use.

def _flatten(x, is_leaf, leaves):
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return ("leaf",)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], is_leaf, leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, is_leaf, leaves) for v in x))
    if x is None:
        return ("none",)
    leaves.append(x)
    return ("leaf",)


def tree_flatten(tree, is_leaf=None):
    """(leaves, treedef) in the reference's leaf order; `is_leaf(x)` true
    stops the walk at x (a spec tuple, say)."""
    leaves = []
    return leaves, TreeDef(_flatten(tree, is_leaf, leaves))


def _unflatten(node, it):
    kind = node[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(node[1], node[2])}
    children = [_unflatten(c, it) for c in node[1]]
    return children if kind == "list" else tuple(children)


def tree_unflatten(treedef: TreeDef, leaves):
    it = iter(leaves)
    out = _unflatten(treedef.node, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_paths(tree):
    """[(key, leaf)] in leaf order, `key` the "/"-joined dict keys and list
    or tuple indices from the root — the checkpoint key the reference
    builds from `jax.tree_util.tree_flatten_with_path`."""
    out = []
    _paths(tree, (), out)
    return out


def _paths(x, path, out):
    if isinstance(x, dict):
        for k in sorted(x):
            _paths(x[k], path + (str(k),), out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _paths(v, path + (str(i),), out)
    elif x is not None:
        out.append(("/".join(path), x))


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over congruent trees."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
