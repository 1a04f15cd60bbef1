"""Weights made by the benchmark from the seed, on the device, in a few
large calls: one normal draw for every weight matrix of a standard
deviation, a fill for the rest.  The program and the
plain reference are handed the same values (the reference's are made again
from the seed, not taken from the program).

A leaf's initialiser comes from the configuration's `init` map, by the
leaf's own name (the last key of its path):

* `normal:<std>`        — N(0, std²)
* `ones`, `zeros`
"""

from __future__ import annotations

import math

import torch


def leaf_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict / list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def map_tree(fn, tree, prefix: str = ""):
    """The tree with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _rule(init: dict, path: str) -> list[str]:
    return init.get(path.rsplit("/", 1)[-1], init["default"]).split(":")


def make_weights(like, seed: int, device, init: dict):
    """A tree shaped as `like` (tensors, meta tensors or shapes) of float32
    weights drawn from `seed` on `device`."""
    items = list(leaf_items(like))
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = lambda x: tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    normal = [(p, x) for p, x in items if _rule(init, p)[0] == "normal"]
    out = {}
    stds = {float(_rule(init, p)[1]) for p, _ in normal}
    for std in sorted(stds):
        group = [(p, x) for p, x in normal if float(_rule(init, p)[1]) == std]
        sizes = [math.prod(shape(x)) for _, x in group]
        buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        buf.normal_(0.0, std, generator=gen)
        for (p, x), piece in zip(group, torch.split(buf, sizes)):
            out[p] = piece.view(shape(x))
    for p, x in items:
        if p not in out:
            kind = _rule(init, p)[0]
            if kind not in ("ones", "zeros"):
                raise ValueError(f"unknown initialiser {kind!r} for {p}")
            fill = torch.ones if kind == "ones" else torch.zeros
            out[p] = fill(shape(x), dtype=torch.float32, device=device)
    return map_tree(lambda p, _: out[p], like)
