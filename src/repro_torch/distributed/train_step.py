"""Train steps (counterpart of `repro/distributed/train_step.py`).

* `make_fsdp_norm_step` — the paper's DDP-/FSDP-Norm: J workers, one
  `torch.distributed` rank each (`launch/mesh.py`).  Each worker takes its
  slice of the global batch, accumulates its minibatch gradient g_j, and
  the workers' valid-token-weighted mean g is all-reduced; the eq. (5)
  statistic comes from g_j and g.  With J = 1 there is no collective.
* `make_accum_norm_step` — beyond-paper ACCUM-NORM on one device: the
  variance statistic comes from the M gradient-accumulation microbatch
  gradients.

Both take a stacked-microbatch batch {tokens/labels: (M, B_global, seq)}
and perform: accumulate grads over M -> statistic -> AdamW -> metrics.

Two residency switches (`stats_impl`, `params_impl`), all four
combinations:

* ('tree', 'tree') — the oracle: params are a tree of leaf tensors, the
  gradient accumulates into a tree of f32 tensors, AdamW runs leaf by leaf.
* ('flat', 'flat') — DESIGN §9/§10: params live in bucket buffers and the
  model runs on views into them (`FlatLayout.unflatten`); each
  microbatch's leaf gradients are added straight into congruent views of
  persistent f32 gradient buffers, so the gradient is born flat with no
  pack; the statistic and the AdamW tail each run one kernel launch over
  every bucket (per dtype group), IN PLACE on the param and moment buffers
  (where the reference donates them).  Under
  FSDP-Norm the params and moments rest as the worker's 1/J shard of each
  bucket: the step all-gathers the params, and each worker updates its
  own shard.
* ('flat', 'tree') — tree-resident params with the flat tail: the mean
  gradient and the params are packed once a step against the shared
  layout, the statistic and the AdamW update run on the buffers (under
  FSDP-Norm on the worker's 1/J shard, its moments a shard too), and the
  updated params come back as views of the (all-gathered) buffers.
* ('tree', 'flat') — flat-resident params with the tree-oracle tail: the
  gradient is born flat, the statistic and AdamW run leaf by leaf on the
  tree views, and the updated tree is packed back (under FSDP-Norm: the
  worker's shard of it).
"""

from __future__ import annotations

import torch

from repro_torch.core.norm_test import (
    accum_variance_stats, paper_faithful_worker_variance, tree_sqnorm,
    worker_variance_stats, worker_variance_stats_buffers,
    worker_variance_stats_flat)
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.distributed.sharding import (
    gather_flat_buffers, shard_bucket, shard_flat_buffers)
from repro_torch.launch.mesh import num_workers, psum, worker_index
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, adamw_update_buffers, clip_scale_from_norm)
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def _check_impls(stats_impl: str, params_impl: str):
    for name, val in (("stats_impl", stats_impl), ("params_impl", params_impl)):
        if val not in ("tree", "flat"):
            raise ValueError(f"{name} must be 'tree' or 'flat', got {val!r}")


def batch_to_device(batch, device):
    """numpy stacked batch -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _accumulate(loss_fn, params, batch, track_micro_sqnorm: bool, acc_g):
    """Loop over the M stacked microbatches, adding each microbatch's
    gradient, weighted by its VALID-TOKEN count w (labels >= 0), into the
    f32 accumulator leaves `acc_g` (zeroed by the caller), in place.

    Per microbatch the gradient comes from `torch.autograd.grad`, so its
    squared norm ‖ĝ^m‖² is available before it is added: Σ_m ‖ĝ^m‖² counts
    only microbatches with w > 0 (a fully padded microbatch carries no
    gradient draw), and m_eff counts them.  The accumulated gradient is
    finally divided by max(Σw, 1), so padded and unpadded batches give the
    same loss and gradient.  Returns (loss, aux, Σ_m‖ĝ^m‖², m_eff, Σw) as
    0-d tensors."""
    leaves, treedef = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(treedef, xs)
    device = xs[0].device
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    acc_loss, acc_aux, acc_sq, acc_w, acc_m = (zero() for _ in range(5))
    for i in range(batch["tokens"].shape[0]):
        mb = {k: v[i] for k, v in batch.items()}
        loss, metrics = loss_fn(tree, mb)
        grads = torch.autograd.grad(loss, xs)
        with torch.no_grad():
            w = (mb["labels"] >= 0).sum().float()
            for a, g in zip(acc_g, grads):
                a.add_(w * g.float())
            if track_micro_sqnorm:
                acc_sq += torch.where(w > 0, tree_sqnorm(list(grads)), 0.0)
            acc_loss += w * loss.detach()
            acc_aux += w * metrics["aux"].detach()
            acc_w += w
            acc_m += (w > 0).float()
    denom = torch.clamp(acc_w, min=1.0)
    with torch.no_grad():
        for a in acc_g:
            a.div_(denom)
    return acc_loss / denom, acc_aux / denom, acc_sq, acc_m, acc_w


# --------------------------------------------------------- FSDP-Norm ----

def worker_batch(batch, idx: int, J: int):
    """Worker `idx`'s contiguous slice of the global-batch dim (dim 1) of
    every (M, B, ...) leaf — what the reference's `P(None, daxes)` gives
    each worker; other leaves are replicated."""
    if J == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.dim() < 2:
            out[k] = v
            continue
        if v.shape[1] % J:
            raise ValueError(f"batch leaf {k!r}: global batch {v.shape[1]} "
                             f"does not split over {J} workers")
        n = v.shape[1] // J
        out[k] = v[:, idx * n:(idx + 1) * n]
    return out


def worker_mean(local, w_j, out):
    """The valid-token-weighted mean over the workers, into the tensors
    `out`: out_i = Σ_j(local_i·w_j) / max(Σ_j w_j, 1).  It equals the plain
    mean on unpadded batches and stays exact when the padded tail of a
    bucketed batch lands unevenly across workers (DESIGN §8).  One worker
    runs the same arithmetic with no collective.  Returns max(Σ_j w_j, 1)."""
    w_sum = torch.clamp(psum(w_j.clone()), min=1.0)
    for o, x in zip(out, local):
        psum(o.copy_(x).mul_(w_j)).div_(w_sum)
    return w_sum


def _sharded_buffer_update(pb_local, gb, opt_state, opt_cfg, lr,
                           grad_sqnorm, idx: int, J: int):
    """FSDP-style sharded flat AdamW (DESIGN §9/§10): the worker's param and
    moment shards are updated IN PLACE from its 1/J slice of the mean
    gradient buffers.  `grad_sqnorm` is the global Σ‖g‖² from the
    statistics: the clip needs the GLOBAL norm, which a per-shard kernel
    byproduct could not give.  Returns (param shards, opt state, grad
    norm)."""
    gb_local = [shard_bucket(b, idx, J) for b in gb]
    _, new_mb, new_vb, count, gnorm, _ = adamw_update_buffers(
        list(pb_local), gb_local, list(opt_state["m"]), list(opt_state["v"]),
        opt_cfg, lr, opt_state["count"], grad_sqnorm=grad_sqnorm)
    return pb_local, {"m": tuple(new_mb), "v": tuple(new_vb),
                      "count": count}, gnorm


def make_fsdp_norm_step(model, opt_cfg: AdamWConfig, *,
                        variance_impl: str = "scalar",
                        stats_impl: str = "tree", params_impl: str = "tree",
                        params_like=None, device=None):
    """Build the FSDP-Norm step of this worker (J = `num_workers()`, j =
    `worker_index()`; every worker builds and calls it in lockstep).
    Returns `wrap`, with `wrap(batch_like)` -> `step(params, opt_state,
    batch, lr) -> (params, opt_state, metrics)` and `wrap.flat_layout` the
    step's shared `FlatLayout` (None on the tree path).

    variance_impl: 'scalar' (one pre-reduced f32 all-reduce, DESIGN §7.1)
    or 'paper' (eq. 5 literal: all-reduce the full (g_j − g)² vector; tree
    residency only, as in the reference).

    Tree params are whole trees, replicated on every worker; flat params
    are the tuple of the worker's 1/J bucket shards
    (`sharding.shard_flat_buffers` of the packed buffers).  Tree stats keep
    whole moment trees; flat stats take `opt_state` from
    `init_adamw_flat(layout=wrap.flat_layout)`, whose buffers are shards
    too.  Flat/flat updates params and moments in place and returns them.
    `batch` holds the GLOBAL batch on the params' device; each worker
    takes its own slice.  Metrics are 0-d f32 tensors, equal on every
    worker.  Without `params_like` the step is built from `model.init(0,
    device)`: on the CUDA card unless `device` names another, and it
    raises without one."""
    _check_impls(stats_impl, params_impl)
    if variance_impl not in ("scalar", "paper"):
        raise ValueError(f"variance_impl must be 'scalar' or 'paper', got "
                         f"{variance_impl!r}")
    if variance_impl == "paper" and stats_impl == "flat":
        raise ValueError("variance_impl='paper' (full-vector all-reduce "
                         "baseline) has no flat-buffer path; use "
                         "stats_impl='tree'")
    if variance_impl == "paper" and params_impl == "flat":
        raise ValueError("variance_impl='paper' walks tree-resident gradient "
                         "leaves; use params_impl='tree'")
    if params_like is None:
        params_like = model.init(0, device)
    if device is None:
        device = tree_flatten(params_like)[0][0].device
    device = torch.device(device)
    J, idx = num_workers(), worker_index()
    # ONE layout per step, shared by the statistics, the AdamW tail and
    # the residency (None on the pure tree path)
    layout = (FlatLayout.from_tree(params_like, shard_divisor=J, device=device)
              if "flat" in (stats_impl, params_impl) else None)
    bufs = {}        # flat params: persistent full params, g_j and g buffers

    def step(params, opt_state, batch, lr):
        batch = worker_batch(batch, idx, J)
        if params_impl == "flat":
            if not bufs:
                bufs["g_j"] = layout.zeros(torch.float32, device)
                bufs["g"] = layout.zeros(torch.float32, device)
                bufs["full"] = ([torch.empty(n, dtype=dt, device=device)
                                 for n, dt in zip(layout.buffer_sizes,
                                                  layout.buffer_dtypes)]
                                if J > 1 else None)
            g_j, g = bufs["g_j"], bufs["g"]
            for b in g_j:
                b.zero_()
            # the params rest as this worker's shards: gather the full
            # buffers (one worker: the params are the full buffers)
            tree = layout.unflatten(gather_flat_buffers(params, bufs["full"]))
            acc = tree_leaves(layout.unflatten(g_j))
        else:
            tree, (leaves, treedef) = params, tree_flatten(params)
            g_j = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            g = [torch.empty_like(x) for x in g_j]
            acc = g_j
        loss, aux, _, _, w_j = _accumulate(model.loss, tree, batch, False, acc)
        w_sum = worker_mean(g_j, w_j, g)     # g_j stays: the statistic needs it
        if params_impl == "flat" and stats_impl == "flat":
            var_l1, gsq = worker_variance_stats_buffers(g_j, g)
            new_params, new_opt, gnorm = _sharded_buffer_update(
                tuple(params), g, opt_state, opt_cfg, lr, gsq, idx, J)
        elif params_impl == "flat":
            # tree-oracle tail on the views, then the worker's shard of the
            # packed result
            g_tree = layout.unflatten(g)
            var_l1, gsq = worker_variance_stats(layout.unflatten(g_j), g_tree)
            with torch.no_grad():
                new_tree, new_opt, gnorm = adamw_update(tree, g_tree, opt_state,
                                                        opt_cfg, lr)
            new_params = tuple(shard_flat_buffers(layout.flatten(new_tree)))
        elif stats_impl == "flat":
            # pack g and the params once; the fused pair hands back the
            # packed mean gradient, the worker updates its shard, and the
            # updated shards are gathered into the tree's buffers
            g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
            var_l1, gsq, gb = worker_variance_stats_flat(g_j, g, layout=layout)
            pb_local = [shard_bucket(b, idx, J) for b in layout.flatten(params)]
            pb_local, new_opt, gnorm = _sharded_buffer_update(
                pb_local, gb, opt_state, opt_cfg, lr, gsq, idx, J)
            new_params = layout.unflatten(gather_flat_buffers(pb_local))
        else:
            g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
            stats = (paper_faithful_worker_variance if variance_impl == "paper"
                     else worker_variance_stats)
            var_l1, gsq = stats(g_j, g)
            with torch.no_grad():
                new_params, new_opt, gnorm = adamw_update(params, g, opt_state,
                                                          opt_cfg, lr)
        # the workers' token-weighted loss and aux, in one collective
        loss, aux = psum(torch.stack([loss * w_j, aux * w_j])) / w_sum
        metrics = {"loss": loss, "aux": aux, "var_l1": var_l1,
                   "grad_sqnorm": gsq, "grad_norm": gnorm,
                   "clip_scale": clip_scale_from_norm(gnorm, opt_cfg.grad_clip)}
        return new_params, new_opt, metrics

    def wrap(batch_like=None):
        return step

    wrap.flat_layout = layout
    return wrap


# -------------------------------------------------------- ACCUM-NORM ----

def make_accum_norm_step(model, opt_cfg: AdamWConfig, *,
                         stats_impl: str = "tree", params_impl: str = "tree",
                         params_like=None, device=None):
    """Build the ACCUM-NORM step.  Returns `wrap`, with `wrap(batch_like)`
    -> `step(params, opt_state, batch, lr) -> (params, opt_state, metrics)`
    (one eager step serves every batch shape) and `wrap.flat_layout` the
    step's shared `FlatLayout` (None on the tree path).  The reference also
    returns sharding specs; a single-device step has none.

    Flat params are the tuple of bucket buffers; flat stats take
    `opt_state` from `init_adamw_flat(layout=wrap.flat_layout)`.  Flat/flat
    updates both in place and returns them.  `batch` holds tensors on the
    params' device (`batch_to_device`); `lr` is a float or 0-d tensor.
    Metrics are 0-d f32 tensors on the device.  Without `params_like` the
    step is built from `model.init(0, device)`: on the CUDA card unless
    `device` names another, and it raises without one."""
    _check_impls(stats_impl, params_impl)
    if params_like is None:
        params_like = model.init(0, device)
    if device is None:
        device = tree_flatten(params_like)[0][0].device
    device = torch.device(device)
    J = 1                      # one device: the data-parallel worker count
    layout = (FlatLayout.from_tree(params_like, shard_divisor=J, device=device)
              if "flat" in (stats_impl, params_impl) else None)
    grad_bufs = []             # persistent f32 gradient buffers (flat params)

    def step(params, opt_state, batch, lr):
        if params_impl == "flat":
            if not grad_bufs:
                grad_bufs.extend(layout.zeros(torch.float32, device))
            for b in grad_bufs:
                b.zero_()
            pb = list(params)
            tree = layout.unflatten(pb)
            acc = tree_flatten(layout.unflatten(grad_bufs))[0]
            loss, aux, sq_sum, m_eff, _ = _accumulate(
                model.loss, tree, batch, True, acc)
            if stats_impl == "flat":
                _, new_mb, new_vb, count, gnorm, gsq = adamw_update_buffers(
                    pb, grad_bufs, list(opt_state["m"]), list(opt_state["v"]),
                    opt_cfg, lr, opt_state["count"])
                new_params = tuple(pb)
                new_opt = {"m": tuple(new_mb), "v": tuple(new_vb),
                           "count": count}
                var_l1, gsq = accum_variance_stats(sq_sum, None, m_eff, J,
                                                   gsq=gsq)
            else:
                # tree-oracle tail on the views, packed back once
                g = layout.unflatten(grad_bufs)
                var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J)
                with torch.no_grad():
                    new_tree, new_opt, gnorm = adamw_update(
                        tree, g, opt_state, opt_cfg, lr)
                new_params = tuple(layout.flatten(new_tree))
        else:
            leaves, treedef = tree_flatten(params)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss, aux, sq_sum, m_eff, _ = _accumulate(
                model.loss, params, batch, True, acc)
            g = tree_unflatten(treedef, acc)
            if stats_impl == "flat":
                # pack g and the params once; the fused tail updates the
                # packed params, whose views are the new tree
                pb = layout.flatten(params)
                _, new_mb, new_vb, count, gnorm, gsq = adamw_update_buffers(
                    pb, layout.flatten(g), list(opt_state["m"]),
                    list(opt_state["v"]), opt_cfg, lr, opt_state["count"])
                new_params = layout.unflatten(pb)
                new_opt = {"m": tuple(new_mb), "v": tuple(new_vb),
                           "count": count}
                var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J,
                                                   gsq=gsq)
            else:
                var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J)
                with torch.no_grad():
                    new_params, new_opt, gnorm = adamw_update(
                        params, g, opt_state, opt_cfg, lr)
        metrics = {"loss": loss, "aux": aux, "var_l1": var_l1,
                   "grad_sqnorm": gsq, "grad_norm": gnorm,
                   "clip_scale": clip_scale_from_norm(gnorm, opt_cfg.grad_clip)}
        return new_params, new_opt, metrics

    def wrap(batch_like=None):
        return step

    wrap.flat_layout = layout
    return wrap
