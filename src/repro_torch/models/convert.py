"""Carry parameters between the reference's pytree and the port's layout.

The reference stacks the parameters of every position in the block
pattern along a leading repeat axis (`params["blocks"][j]`, leaves of shape
(L, ...), from its vmapped init) and keeps heterogeneous prefix layers in
`params["prefix_blocks"]`.  The port keeps one dict per layer, in execution
order, under `params["layers"]`.  Leaf shapes inside a layer are the same
in both — MoE layers' 3-D expert tensors and `shared` subtree, MLA's
projections and norms, the SSD and RG-LRU leaves, an encoder-decoder
layer's `cross_attn` and `cross_norm` included — so conversion is
unstacking (and stacking back), nothing else.  Every other subtree (the
embeddings, the final norm, Whisper's `encoder`) is the same in both.

Both directions work on any tree with the parameter structure — gradients
and optimizer moments too — and take / return numpy arrays on the
reference side, so neither package imports the other.

`stack_layers` / `unstack_layers` are the two hops on torch tensors;
the training loop also writes its checkpoints in the reference's layout
with them, so a checkpoint crosses between the packages.

Decode caches convert the same way: the reference's
{"prefix": [...], "scanned": [leaves of shape (L, b, ...)]} against the
port's per-layer list (`cache_from_jax`, `cache_to_jax`), a layer's
cache {"k", "v"}, MLA's {"c_kv", "k_rope"}, RG-LRU's {"h", "conv"} or
SSD's {"ssm", "conv"} (None for a recurrent layer's prefill cache, as in
the reference).  An encoder-decoder model's cross-attention caches, the
reference's {"cross_prefix", "cross_scanned"} groups of {"k", "v"}, are
the "cross_k" and "cross_v" entries of the port's layer caches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy has no native bf16
        return torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16) \
            .view(torch.float32).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)      # a private copy


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bf16 numpy dtype
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The port's parameter tree from the reference's (numpy leaves)."""
    return unstack_layers(tree_map(lambda a: _to_torch(a, device), np_tree), cfg)


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """Inverse of `params_from_jax`: the reference's tree, numpy leaves."""
    return tree_map(_to_numpy, stack_layers(params, cfg))


def stack_layers(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's layout of a port tree with the parameter structure
    (params, gradients, moments; torch leaves on the tree's device)."""
    n_prefix = len(cfg.prefix_pattern)
    layers = tree["layers"]
    out = {k: v for k, v in tree.items() if k != "layers"}
    if n_prefix:
        out["prefix_blocks"] = list(layers[:n_prefix])
    pattern = len(cfg.block_pattern)
    scanned = layers[n_prefix:]
    out["blocks"] = [tree_map(lambda *xs: torch.stack(xs), *scanned[j::pattern])
                     for j in range(pattern)]
    return out


def unstack_layers(tree: dict, cfg: ModelConfig) -> dict:
    """Inverse of `stack_layers`: the port's per-layer tree, each leaf its
    own tensor (a copy of its slice of the stacked leaf)."""
    pattern = cfg.block_pattern
    layers = list(tree.get("prefix_blocks", []))
    for r in range(cfg.num_repeats):
        for j in range(len(pattern)):
            layers.append(tree_map(lambda a: a[r].clone(), tree["blocks"][j]))
    out = {k: v for k, v in tree.items()
           if k not in ("blocks", "prefix_blocks")}
    out["layers"] = layers
    return out


def _layers_from_jax(prefix, scanned, cfg: ModelConfig, device) -> list:
    layers = [tree_map(lambda a: _to_torch(a, device), c) for c in prefix]
    for r in range(cfg.num_repeats):
        for sub in scanned:
            layers.append(tree_map(lambda a: _to_torch(np.asarray(a)[r], device),
                                   sub))
    return layers


def cache_from_jax(np_cache: dict, cfg: ModelConfig, device="cpu") -> list:
    """The port's per-layer decode cache from the reference's (numpy
    leaves): prefix layers, then the scanned repeats in execution order;
    cross-attention caches, where there are any, merged into their
    layers' caches."""
    layers = _layers_from_jax(np_cache.get("prefix", []), np_cache["scanned"],
                              cfg, device)
    if "cross_scanned" in np_cache:
        cross = _layers_from_jax(np_cache.get("cross_prefix", []),
                                 np_cache["cross_scanned"], cfg, device)
        layers = [dict(c, cross_k=x["k"], cross_v=x["v"])
                  for c, x in zip(layers, cross, strict=True)]
    return layers


def _layers_to_jax(layers: list, cfg: ModelConfig):
    n_prefix = len(cfg.prefix_pattern)
    pattern = len(cfg.block_pattern)
    scanned = layers[n_prefix:]
    stack = lambda *xs: np.stack([_to_numpy(x) for x in xs])
    return ([tree_map(_to_numpy, c) for c in layers[:n_prefix]],
            [tree_map(stack, *scanned[j::pattern]) for j in range(pattern)])


def cache_to_jax(cache: list, cfg: ModelConfig) -> dict:
    """Inverse of `cache_from_jax`: the reference's cache tree, numpy
    leaves."""
    cross = [None if c is None or "cross_k" not in c
             else {"k": c["cross_k"], "v": c["cross_v"]} for c in cache]
    own = [c if c is None else {k: v for k, v in c.items()
                                if k not in ("cross_k", "cross_v")} for c in cache]
    prefix, scanned = _layers_to_jax(own, cfg)
    out = {"prefix": prefix, "scanned": scanned}
    if any(x is not None for x in cross):
        out["cross_prefix"], out["cross_scanned"] = _layers_to_jax(cross, cfg)
    return out
