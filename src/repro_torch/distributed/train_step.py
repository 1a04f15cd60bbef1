"""Train steps (counterpart of `repro/distributed/train_step.py`).

`make_accum_norm_step` — beyond-paper ACCUM-NORM on one device: the
variance statistic comes from the M gradient-accumulation microbatch
gradients.  It takes a stacked-microbatch batch {tokens/labels: (M, B,
seq)} and performs: accumulate grads over M -> statistic -> AdamW ->
metrics.

Two residency combinations (`stats_impl`, `params_impl`):

* ('tree', 'tree') — the oracle: params are a tree of leaf tensors, the
  gradient accumulates into a tree of f32 tensors, AdamW runs leaf by leaf
  and returns new tensors.
* ('flat', 'flat') — DESIGN §9/§10: params live in bucket buffers and the
  model runs on views into them (`FlatLayout.unflatten`); each
  microbatch's leaf gradients are added straight into congruent views of
  persistent f32 gradient buffers, so the gradient is born flat with no
  pack; the AdamW tail runs one kernel launch per bucket, IN PLACE on the
  param and moment buffers (where the reference donates them), and its Σg²
  byproduct feeds the variance statistic.

The mixed combinations and FSDP-Norm on `torch.distributed` arrive with
slice 2 (ROADMAP).
"""

from __future__ import annotations

import torch

from repro_torch.core.norm_test import accum_variance_stats, tree_sqnorm
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, adamw_update_buffers, clip_scale_from_norm)
from repro_torch.tree import tree_flatten, tree_unflatten

_SLICE2 = "arrives with slice 2"


def _check_impls(stats_impl: str, params_impl: str):
    for name, val in (("stats_impl", stats_impl), ("params_impl", params_impl)):
        if val not in ("tree", "flat"):
            raise ValueError(f"{name} must be 'tree' or 'flat', got {val!r}")
    if stats_impl != params_impl:
        raise NotImplementedError(
            f"stats_impl={stats_impl!r} with params_impl={params_impl!r} "
            f"{_SLICE2}")


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


def make_accum_norm_step(model, opt_cfg: AdamWConfig, *,
                         stats_impl: str = "tree", params_impl: str = "tree",
                         params_like=None, device=None):
    """Build the ACCUM-NORM step.  Returns `wrap`, with `wrap(batch_like)`
    -> `step(params, opt_state, batch, lr) -> (params, opt_state, metrics)`
    (one eager step serves every batch shape) and `wrap.flat_layout` the
    step's shared `FlatLayout` (None on the tree path).  The reference also
    returns sharding specs; a single-device step has none.

    On the flat path `params` is the tuple of bucket buffers and
    `opt_state` comes from `init_adamw_flat(layout=wrap.flat_layout)`; both
    are updated in place and returned.  `batch` holds tensors on the
    params' device (`batch_to_device`); `lr` is a float or 0-d tensor.
    Metrics are 0-d f32 tensors on the device."""
    _check_impls(stats_impl, params_impl)
    if params_like is None:
        params_like = model.init(0, device or "cpu")
    if device is None:
        device = tree_flatten(params_like)[0][0].device
    device = torch.device(device)
    J = 1                      # one device: the data-parallel worker count
    layout = (FlatLayout.from_tree(params_like, shard_divisor=J, device=device)
              if params_impl == "flat" else None)
    grad_bufs = []             # persistent f32 gradient buffers (flat path)

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
            _, new_mb, new_vb, count, gnorm, gsq = adamw_update_buffers(
                pb, grad_bufs, list(opt_state["m"]), list(opt_state["v"]),
                opt_cfg, lr, opt_state["count"])
            new_params = tuple(pb)
            new_opt = {"m": tuple(new_mb), "v": tuple(new_vb), "count": count}
            var_l1, gsq = accum_variance_stats(sq_sum, None, m_eff, J, gsq=gsq)
        else:
            leaves, treedef = tree_flatten(params)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss, aux, sq_sum, m_eff, _ = _accumulate(
                model.loss, params, batch, True, acc)
            g = tree_unflatten(treedef, acc)
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
