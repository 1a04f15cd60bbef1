"""Parameter / optimizer-state / cache specs, and each rank's slices of a
tree (counterpart of `repro/distributed/params.py`).

Specs come from the leaf *names* (wq, w_gate, table, ...) with the
reference's divisibility sanitizer: an axis that does not divide its
dimension is dropped (internvl2's 14 heads or whisper's 51865 vocab on a
16-wide model axis stay replicated).  A spec is a plain tuple (see
`distributed/sharding.py`).

The port's tree keeps one dict per layer under `layers` (no leading scan
axis); a layer leaf takes the spec the reference gives the same leaf in
`prefix_blocks`, i.e. its stacked `blocks` spec without the leading None.
Every other key is the reference's own, `encoder/blocks/i/...` included,
whose path the reference's rule reads as scanned: the encoder's leaves
stay replicated there, and so here.

Two layouts, as in the reference:
  * fsdp=False — FSDP-Norm: tensor dims over `model` only;
  * fsdp=True  — ACCUM-NORM: also a non-TP dim ("F") over the data axes
    (ZeRO-3).

`shard_tree` / `gather_tree` move between whole leaves and this rank's
slices of them over a mesh built inside a process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import entry_axes, spec_entry
from repro_torch.launch.mesh import MODEL, SELF, data_axes
from repro_torch.tracing import span
from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

# name -> preferred axes per dim; "F" takes the fsdp axes when fsdp=True
_TABLE = {
    # embeddings
    "table": ("VOCAB_OR_F", None),
    # attention (d, H, hd) / (H, hd, d)
    "wq": ("F", MODEL, None),
    "wk": ("F", MODEL, None),
    "wv": ("F", MODEL, None),
    "wo": (MODEL, None, "F"),
    # MLA
    "w_dq": ("F", None),
    "w_uq": ("F", MODEL, None),
    "w_dkv": ("F", None),
    "w_krope": ("F", None),
    "w_uk": ("F", MODEL, None),
    "w_uv": ("F", MODEL, None),
    "w_o": (MODEL, None, "F"),
    # dense mlp
    "w_gate": ("F", MODEL),
    "w_up": ("F", MODEL),
    "w_down": (MODEL, "F"),
    # moe router
    "router": ("F", None),
    # rglru
    "w_branch_a": ("F", MODEL),
    "w_branch_b": ("F", MODEL),
    "w_rg": ("F", MODEL),
    "w_ig": ("F", MODEL),
    "w_out": (MODEL, "F"),
    "conv_w": (None, MODEL),
    # ssd
    "w_in": ("F", MODEL),
}

# MoE expert tensors are 3-D with names shared with the dense mlp
_MOE_TABLE = {
    "w_gate": (MODEL, "F", None),
    "w_up": (MODEL, "F", None),
    "w_down": (MODEL, "F", None),
}


def _sanitize(spec_axes, shape, mesh) -> tuple:
    out = []
    for dim, axes in zip(shape, spec_axes):
        if axes is None:
            out.append(None)
            continue
        axes_t = entry_axes(axes)
        size = 1
        ok = True
        for a in axes_t:
            if a not in mesh.shape:
                ok = False
                break
            size *= mesh.shape[a]
        if ok and dim % size == 0 and size > 1:
            out.append(spec_entry(axes))
        else:
            out.append(None)
    return tuple(out)


def _leaf_spec(path_key: str, shape, mesh, fsdp_axes) -> tuple:
    name = path_key.split("/")[-1]
    in_scan = path_key.startswith("blocks/") or "/blocks/" in path_key
    ndim = len(shape) - (1 if in_scan else 0)

    axes = None
    if name in _MOE_TABLE and ndim == 3:
        axes = _MOE_TABLE[name]            # expert tensors (E, d, f)
    elif name in _TABLE and len(_TABLE[name]) == ndim:
        axes = _TABLE[name]

    if axes is None:
        spec_axes = [None] * ndim
    else:
        spec_axes = []
        for a in axes:
            if a == "F":
                spec_axes.append(fsdp_axes if fsdp_axes else None)
            elif a == "VOCAB_OR_F":
                spec_axes.append(MODEL if not fsdp_axes else fsdp_axes)
            else:
                spec_axes.append(a)
    if in_scan:
        spec_axes = [None] + list(spec_axes)
    return _sanitize(spec_axes, shape, mesh)


def _map_paths(fn, tree):
    """`fn(path_key, leaf)` over the tree's leaves, same structure."""
    _, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(k, x) for k, x in tree_paths(tree)])


def param_pspecs(params, mesh, *, fsdp: bool = False):
    """The spec tree matching `params` (tensors, meta tensors or anything
    with a `shape`)."""
    fsdp_axes = data_axes(mesh) if fsdp else ()
    return _map_paths(lambda k, x: _leaf_spec(k, tuple(x.shape), mesh,
                                              fsdp_axes), params)


def opt_pspecs(opt_state, param_specs):
    """Optimizer moments share the parameter layout; count is replicated."""
    return {"m": param_specs, "v": param_specs, "count": ()}


# a cache at least this long whose heads stay whole on `model` (attention
# kv heads that do not divide the axis, MLA's latents) has its time axis
# over `model` instead
SEQ_SHARD_LEN = 8192


def seq_sharded(length: int, msize: int) -> bool:
    """Whether a cache of `length` positions, whose heads are not on the
    model axis, lies over `model` by its time axis (`cache_pspecs`'s rule
    after the sanitizer: long enough and divisible)."""
    return msize > 1 and length >= SEQ_SHARD_LEN and length % msize == 0


def cache_pspecs(cache, mesh, batch_divisible: bool):
    """Decode caches (the port's per-layer list): batch over the data axes
    when divisible, kv heads over `model` when divisible (else a long
    cache's sequence, `seq_sharded`), latent and recurrent widths over
    `model`.  A layer's cross-attention "cross_k" / "cross_v" take the
    reference's cross "k" / "v" rule."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh.shape[a]
    msize = mesh.shape.get(MODEL, 1)

    def leaf(key, x):
        name = key.split("/")[-1].removeprefix("cross_")
        shape = tuple(x.shape)
        ndim = len(shape)
        baxes = daxes if (batch_divisible and shape[0] % dsize == 0) else None
        if name in ("k", "v") and ndim == 4:          # (b, s, kv, hd)
            if shape[-2] % msize == 0 and msize > 1:
                axes = [baxes, None, MODEL, None]
            elif shape[-3] >= SEQ_SHARD_LEN:
                axes = [baxes, MODEL, None, None]
            else:
                axes = [baxes, None, None, None]
        elif name in ("c_kv", "k_rope") and ndim == 3:  # (b, s, r)
            axes = [baxes, MODEL if shape[-2] >= SEQ_SHARD_LEN else None, None]
        elif name == "ssm" and ndim == 4:              # (b, nh, n, p)
            axes = [baxes, MODEL, None, None]
        elif name == "conv" and ndim == 3:             # (b, k, c)
            axes = [baxes, None, MODEL]
        elif name == "h" and ndim == 2:                # rglru state (b, w)
            axes = [baxes, MODEL]
        else:
            axes = [baxes] + [None] * (ndim - 1)
        return _sanitize(axes, shape, mesh)

    return _map_paths(leaf, cache)


# ------------------------------------------------------- rank slices ----

def strip_spec(spec: tuple, axes) -> tuple:
    """`spec` with `axes` removed from every dim."""
    drop = set(axes)
    return tuple(spec_entry(tuple(a for a in entry_axes(e) if a not in drop))
                 for e in spec)


def _dims(spec, only):
    """(dim, axes) of every sharded dim of `spec`, limited to dims whose
    axes lie in `only` (None: all)."""
    out = []
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if axes and (only is None or set(axes) <= set(only)):
            out.append((d, axes))
    return out


def shard_tree(tree, specs, mesh, axes=None):
    """This rank's slice of every leaf, as views (`narrow`): along each
    sharded dim (limited to `axes` when given) the rank's index over its
    axes, first axis major."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = tree_flatten(specs, is_leaf=_is_spec)[0]
    out = []
    for x, spec in zip(leaves, spec_leaves):
        for d, ax in _dims(spec, axes):
            n = x.shape[d] // _size(mesh, ax)
            x = x.narrow(d, mesh.axes_index(ax) * n, n)
        out.append(x)
    return tree_unflatten(treedef, out)


def gather_tree(tree, specs, mesh, axes=None):
    """Whole leaves from every rank's slices: each sharded dim (limited to
    `axes` when given) all-gathered over its group, in shard order.  Every
    rank of the mesh calls it in lockstep."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = tree_flatten(specs, is_leaf=_is_spec)[0]
    out = []
    for x, spec in zip(leaves, spec_leaves):
        for d, ax in reversed(_dims(spec, axes)):
            group = mesh.group_for(ax)
            n = _size(mesh, ax)
            if group is SELF or n == 1:
                continue
            parts = [torch.empty_like(x.contiguous()) for _ in range(n)]
            with span("comm.all_gather", bytes=n * x.nbytes, group=n):
                dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
        out.append(x)
    return tree_unflatten(treedef, out)


def spec_paths(specs):
    """[(key, spec)] of a spec tree in leaf order, `key` as `tree_paths`
    builds it."""
    out = []

    def rec(x, path):
        if _is_spec(x):
            out.append(("/".join(path), x))
        elif isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], path + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                rec(v, path + (str(i),))

    rec(specs, ())
    return out


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def map_specs(fn, specs):
    """`fn(spec)` over a spec tree, same structure."""
    leaves, treedef = tree_flatten(specs, is_leaf=_is_spec)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# (leaf, the sibling on `model` that makes it "partial"): whole leaves
# used inside a sharded region on this rank's part only
_PARTIAL = {
    "wk": "wq", "wv": "wq",          # kv heads that do not divide the axis
    "w_q": "w_uk",                   # MLA without a query LoRA
    # RG-LRU's (w,) vectors, applied to this rank's columns
    "conv_b": "w_branch_b", "b_rg": "w_branch_b", "b_ig": "w_branch_b",
    "lam": "w_branch_b",
}

# the norms applied to the residual stream, which under sequence
# parallelism run on this rank's slice of the sequence
STREAM_NORMS = frozenset({"pre_norm", "post_norm", "mlp_norm", "post_mlp_norm",
                          "cross_norm", "final_norm"})


def model_roles(params, specs, sequence_parallel: bool = False):
    """Each leaf's part under the model axis, from its spec and its
    siblings':

    * "sharded" — a dim on `model`: the rank holds its slice, and its
      gradient is its slice of the whole gradient;
    * "partial" — whole, but used inside a sharded region on this rank's
      part only, so each rank's gradient is a share that the step sums
      over the model group: attention's `wk` / `wv` whose kv heads do not
      divide the axis, MLA's `w_q` (no query LoRA), and RG-LRU's
      `conv_b`, `b_rg`, `b_ig` and `lam`; with `sequence_parallel`, also
      the leaves of the norms on the residual stream (`STREAM_NORMS`:
      every block's, the cross-attention's, the final norms of the
      decoder and the encoder), which run on this rank's slice of the
      sequence;
    * "replicated" — whole, with a gradient every rank computes whole and
      the same, counted once: the norms, the MoE router (its gates'
      gradient is summed over the group inside the layer), MLA's latent
      projections and norms, SSD's `conv_b`, `a_log`, `dt_bias`, `d_skip`
      and `norm_scale` (the mixer runs whole on every rank), and every
      leaf outside the sharded regions."""
    spec_of = dict(zip((k for k, _ in tree_paths(params)),
                       tree_flatten(specs, is_leaf=_is_spec)[0]))
    on_model = lambda s: any(MODEL in entry_axes(e) for e in s)

    def role(key, _):
        if on_model(spec_of[key]):
            return "sharded"
        if sequence_parallel and STREAM_NORMS.intersection(key.split("/")):
            return "partial"
        parent, name = key.rsplit("/", 1)[0], key.split("/")[-1]
        sibling = _PARTIAL.get(name)
        if sibling and on_model(spec_of.get(f"{parent}/{sibling}", ())):
            return "partial"
        return "replicated"

    return _map_paths(role, params)


__all__ = ["param_pspecs", "opt_pspecs", "cache_pspecs", "seq_sharded",
           "STREAM_NORMS",
           "SEQ_SHARD_LEN", "shard_tree",
           "gather_tree", "strip_spec", "map_specs", "model_roles", "spec_paths"]
