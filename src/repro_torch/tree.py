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


def tree_flatten(tree, is_leaf=None):
    """(leaves, treedef) in the reference's leaf order; `is_leaf(x)` true
    stops the walk at x (a spec tuple, say)."""
    leaves = []

    def rec(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return ("leaf",)
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(rec(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(rec(v) for v in x))
        if x is None:
            return ("none",)
        leaves.append(x)
        return ("leaf",)

    return leaves, TreeDef(rec(tree))


def tree_unflatten(treedef: TreeDef, leaves):
    it = iter(leaves)

    def rec(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: rec(c) for k, c in zip(node[1], node[2])}
        children = [rec(c) for c in node[1]]
        return children if kind == "list" else tuple(children)

    out = rec(treedef.node)
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

    def rec(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], path + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                rec(v, path + (str(i),))
        elif x is not None:
            out.append(("/".join(path), x))

    rec(tree, ())
    return out


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over congruent trees."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
