"""Communication-efficient local-update training with adaptive batch sizes
(counterpart of `repro/distributed/local_step.py`) — the paper's companion
scheme (Lau, Li, Xu, Liu, Kolar, arXiv:2406.13936).

Each data-parallel worker (a `torch.distributed` rank, as in FSDP-Norm)
takes H local AdamW steps on its own replica between synchronizations; at
sync, parameters and moments are averaged (all-reduces once per H steps
instead of every step), and the adaptive batch statistic is computed from
the *divergence of worker updates*:

    Δ_j = w_j^{(H)} − w^{(0)},   Δ = (1/J) Σ_j Δ_j
    var_l1 = (1/J) Σ_j ‖Δ_j − Δ‖²,  stat vs ‖Δ‖²

which plays the role eq. (5)'s per-worker gradient variance plays in
DDP-Norm.  Same controller, same rounding.

`params_impl='flat'` (DESIGN §10) keeps the replica flat-RESIDENT through
the whole round: the model runs on views of the bucket buffers, each local
step's gradient is written straight into congruent views of f32 gradient
buffers (born flat), the buffer AdamW runs one `fused_adamw_stats` launch
per dtype group on the card, and the update-divergence statistic is one
`fused_stats` launch over the Δ buffers — the round performs no pack.
"""

from __future__ import annotations

import torch

from repro_torch.core.norm_test import (
    tree_sqdiff, tree_sqnorm, worker_variance_stats_buffers,
    worker_variance_stats_flat)
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.distributed.train_step import _check_impls, worker_batch
from repro_torch.launch.mesh import num_workers, pmean, worker_index
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, adamw_update_buffers)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _local_grads(model, tree, mb):
    """(loss, gradient leaves) of one local step on the replica `tree`."""
    leaves, treedef = tree_flatten(tree)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, xs), mb)
    return loss.detach(), torch.autograd.grad(loss, xs), treedef


def make_local_sgd_step(model, opt_cfg: AdamWConfig, *,
                        stats_impl: str = "tree", params_impl: str = "tree",
                        params_like=None, device=None, bucket_bytes=None):
    """Build this worker's local-SGD round (J = `num_workers()`, every
    worker calls it in lockstep).  Returns `wrap`, with `wrap(batch_like)`
    -> `round(params, opt_state, batch, lr) -> (params', opt', metrics)`
    where batch leaves are (H, B_global, ...) — H local steps per sync —
    and each worker takes its slice of the global-batch dim; and
    `wrap.flat_layout` the round's shared `FlatLayout` (None on the pure
    tree path).

    stats_impl='flat' computes the update-divergence pair (‖Δ_j − Δ‖² and
    ‖Δ‖²) with the single-pass fused statistic over bucketed buffers
    instead of the leaf-by-leaf sqdiff + sqnorm double pass.

    params_impl='flat' makes the replica flat-resident for the whole round;
    `params` is the tuple of whole bucket buffers (replicas are per-worker
    whole copies — no shard divisor) and `opt_state` comes from
    `init_adamw_flat(layout=wrap.flat_layout)`.  Its moment buffers are
    updated in place, where the reference donates them; the returned
    params and moments are new tensors, the workers' means.  Tree stats
    over flat params are rejected, as in the reference: the flat round
    always runs the buffer AdamW.  `bucket_bytes`: the layout's bucket
    size (default: the device's)."""
    _check_impls(stats_impl, params_impl)
    if params_impl == "flat" and stats_impl == "tree":
        raise ValueError("local-SGD has no tree-oracle tail over flat "
                         "params; use stats_impl='flat' with "
                         "params_impl='flat'")
    if params_like is None:
        params_like = model.init(0, device)
    if device is None:
        device = tree_leaves(params_like)[0].device
    device = torch.device(device)
    J, idx = num_workers(), worker_index()
    # Δ_j and Δ are param-shaped, so they pack through the params layout
    layout = (FlatLayout.from_tree(params_like, bucket_bytes, device=device)
              if "flat" in (stats_impl, params_impl) else None)
    grad_bufs = []             # persistent f32 gradient buffers (flat round)

    def sync(losses):
        return pmean(torch.mean(torch.stack(losses)))

    def round_tree(params, opt_state, batch, lr):
        batch = worker_batch(batch, idx, J)
        p, o, losses = params, opt_state, []
        for h in range(batch["tokens"].shape[0]):
            loss, grads, treedef = _local_grads(
                model, p, {k: v[h] for k, v in batch.items()})
            with torch.no_grad():
                p, o, _ = adamw_update(p, tree_unflatten(treedef, list(grads)),
                                       o, opt_cfg, lr)
            losses.append(loss)
        with torch.no_grad():
            # inter-worker update divergence (the adaptive-batch statistic)
            delta_j = tree_map(lambda a, b: a.float() - b.float(), p, params)
            delta = tree_map(pmean, delta_j)
            if stats_impl == "flat":
                var_l1, dsq, _ = worker_variance_stats_flat(delta_j, delta,
                                                            layout=layout)
            else:
                var_l1 = pmean(tree_sqdiff(delta_j, delta))
                dsq = tree_sqnorm(delta)
            # synchronize: average replicas (params AND moments)
            p_avg = tree_map(pmean, p)
            o_avg = {"m": tree_map(pmean, o["m"]), "v": tree_map(pmean, o["v"]),
                     "count": o["count"]}
        return p_avg, o_avg, _metrics(sync(losses), var_l1, dsq)

    def round_flat(pb, opt_state, batch, lr):
        batch = worker_batch(batch, idx, J)
        if not grad_bufs:
            grad_bufs.extend(layout.zeros(torch.float32, device))
        p = [b.clone() for b in pb]        # the replica; pb stays w^(0)
        tree = layout.unflatten(p)         # views: updates land in the model
        acc = tree_leaves(layout.unflatten(grad_bufs))
        mb, vb = list(opt_state["m"]), list(opt_state["v"])
        count, losses = opt_state["count"], []
        for h in range(batch["tokens"].shape[0]):
            loss, grads, _ = _local_grads(model, tree,
                                          {k: x[h] for k, x in batch.items()})
            with torch.no_grad():
                for a, g in zip(acc, grads):       # born flat
                    a.copy_(g)
                _, mb, vb, count, _, _ = adamw_update_buffers(
                    p, grad_bufs, mb, vb, opt_cfg, lr, count)
            losses.append(loss)
        with torch.no_grad():
            # born-flat update divergence: buffer arithmetic, no pack
            delta_j = [a.float() - b.float() for a, b in zip(p, pb)]
            delta = [pmean(x) for x in delta_j]
            var_l1, dsq = worker_variance_stats_buffers(delta_j, delta)
            o_avg = {"m": tuple(pmean(x) for x in mb),
                     "v": tuple(pmean(x) for x in vb), "count": count}
            p_avg = tuple(pmean(x) for x in p)
        return p_avg, o_avg, _metrics(sync(losses), var_l1, dsq)

    round_fn = round_flat if params_impl == "flat" else round_tree

    def wrap(batch_like=None):
        return round_fn

    wrap.flat_layout = layout
    return wrap


def _metrics(loss, var_l1, dsq):
    return {"loss": loss, "var_l1": var_l1, "grad_sqnorm": dsq,
            "aux": torch.zeros((), dtype=torch.float32, device=loss.device),
            "grad_norm": torch.sqrt(dsq)}
