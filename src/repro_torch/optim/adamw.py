"""AdamW (Algorithm 1's optimizer block) with decoupled weight decay, bias
correction and global-norm gradient clipping (counterpart of
`repro/optim/adamw.py`).  Optimizer moments are f32 regardless of param
dtype.

* `adamw_update` — the tree oracle: leaf by leaf, returns new tensors
  (with `use_kernel`, one per-tensor `fused_adamw` launch a leaf, in place).
* `adamw_update_buffers` — the flat-buffer path (DESIGN §9): one
  `kernels.ops.adamw_flat_buckets` call over every bucket (on the card one
  `fused_adamw_stats` launch per dtype group), updating params and moments
  IN PLACE (where the reference step donates its buffers), with the
  gradient's Σg² as the kernel's byproduct.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.norm_test import tree_sqnorm
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_kernel: bool = False


def _count(device):
    return torch.zeros((), dtype=torch.int32, device=device)


def init_adamw(params):
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    leaves = tree_flatten(params)[0]
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "count": _count(leaves[0].device if leaves else "cpu")}


def clip_scale_from_norm(grad_norm, grad_clip: float):
    """THE global-norm clip multiplier — the single definition the updates
    apply and the `clip_scale` step metric reports."""
    if grad_clip <= 0:
        return torch.ones((), dtype=torch.float32, device=grad_norm.device)
    return torch.clamp(grad_clip / (grad_norm + 1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gnorm = torch.sqrt(tree_sqnorm(grads))
    scale = clip_scale_from_norm(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _bias_corrections(cfg: AdamWConfig, count):
    n = count.float()
    return 1.0 - cfg.beta1 ** n, 1.0 - cfg.beta2 ** n


def adamw_update(params, grads, state, cfg: AdamWConfig, lr):
    """One AdamW step on trees (the oracle); returns (new_params, new_state,
    grad_norm) as new tensors.  `lr` may be a float or a 0-d tensor.

    With `cfg.use_kernel` the update runs leaf by leaf through
    `kernels.ops.fused_adamw_tree` (the per-tensor `fused_adamw` kernel on
    the card), IN PLACE on the params and moments passed in, where the
    reference step donates them."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = torch.sqrt(tree_sqnorm(grads))
    count = state["count"] + 1
    c1, c2 = _bias_corrections(cfg, count)

    if cfg.use_kernel:
        from repro_torch.kernels.ops import fused_adamw_tree
        new_params, new_m, new_v = fused_adamw_tree(
            params, grads, state["m"], state["v"], lr=lr, beta1=cfg.beta1,
            beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
            c1=c1, c2=c2)
        return new_params, {"m": new_m, "v": new_v, "count": count}, gnorm

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.beta1 * m + (1 - cfg.beta1) * g32
        v = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g32)
        mhat = m / c1
        vhat = v / c2
        p32 = p.float()
        p32 = (1.0 - lr * cfg.weight_decay) * p32 - lr * mhat / (torch.sqrt(vhat) + cfg.eps)
        return p32.to(p.dtype), m, v

    lp, treedef = tree_flatten(params)
    outs = [upd(*xs) for xs in zip(lp, tree_flatten(grads)[0],
                                   tree_flatten(state["m"])[0],
                                   tree_flatten(state["v"])[0])]
    unf = lambda i: tree_unflatten(treedef, [o[i] for o in outs])
    return unf(0), {"m": unf(1), "v": unf(2), "count": count}, gnorm


# -------------------------------------------------- flat-buffer path ----

def init_adamw_flat(params, *, shard_divisor: int = 1, layout=None,
                    device=None):
    """Moments as flat f32 buffers (tuples) matching the params' `FlatLayout`
    (rebuilt deterministically when `layout` is not given).  With a layout
    of shard divisor J > 1 each buffer is this worker's 1/J shard of its
    bucket — the port's form of the reference's moments sharded over the
    data axes: a worker holds only its own shard, and since the moments
    start at zero the shard needs no worker index.  (A resumed run's
    moments are not zero: `launch/train.py` takes each worker's shard of
    the restored full buffers.)"""
    from repro_torch.distributed.flatbuf import FlatLayout
    leaves = tree_flatten(params)[0]
    if device is None:
        device = leaves[0].device if leaves else "cpu"
    if layout is None:
        layout = FlatLayout.from_tree(params, shard_divisor=shard_divisor,
                                      device=device)
    zeros = lambda: tuple(torch.zeros(n // layout.shard_divisor,
                                      dtype=torch.float32, device=device)
                          for n in layout.buffer_sizes)
    return {"m": zeros(), "v": zeros(), "count": _count(device)}


def flat_opt_state(params_like, state, *, shard_divisor: int = 1,
                   layout=None):
    """Convert a tree optimizer state to the flat layout (tests/migration):
    whole buffers, not a worker's shard."""
    from repro_torch.distributed.flatbuf import FlatLayout
    if layout is None:
        layout = FlatLayout.from_tree(params_like, shard_divisor=shard_divisor)
    return {"m": tuple(layout.flatten(state["m"])),
            "v": tuple(layout.flatten(state["v"])),
            "count": state["count"]}


def unflat_opt_state(params_like, state, *, shard_divisor: int = 1,
                     layout=None):
    """Inverse of `flat_opt_state` (bit-exact; the moments are views of the
    buffers)."""
    from repro_torch.distributed.flatbuf import FlatLayout
    if layout is None:
        layout = FlatLayout.from_tree(params_like, shard_divisor=shard_divisor)
    return {"m": layout.unflatten(list(state["m"])),
            "v": layout.unflatten(list(state["v"])),
            "count": state["count"]}


def adamw_update_buffers(pb, gb, mb, vb, cfg: AdamWConfig, lr, count, *,
                         grad_sqnorm=None):
    """The buffer-level AdamW tail: one fused call over every bucket, IN
    PLACE on the param buffers `pb` and moment buffers `mb`, `vb`.

    If the caller already holds Σ‖g‖², pass it as `grad_sqnorm` and the clip
    norm costs zero extra passes; otherwise it comes from the kernel's
    byproduct (no clipping) or one read-only reduction over the gradient
    buffers (clipping enabled — the clip scale must be known before the
    update runs).

    Returns (pb, mb, vb, new_count, grad_norm, grad_sqnorm)."""
    from repro_torch.kernels import ops

    if not len(pb) == len(gb) == len(mb) == len(vb):
        raise ValueError("flat state does not match the params layout "
                         f"({len(pb)} vs {len(mb)} buffers)")
    count = count + 1
    c1, c2 = _bias_corrections(cfg, count)
    device = count.device
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)

    if cfg.grad_clip > 0 and grad_sqnorm is None:
        grad_sqnorm = torch.zeros((), dtype=torch.float32, device=device)
        for g in gb:
            grad_sqnorm = grad_sqnorm + torch.sum(torch.square(g.float()))
    scale = (clip_scale_from_norm(torch.sqrt(grad_sqnorm), cfg.grad_clip)
             if cfg.grad_clip > 0
             else torch.ones((), dtype=torch.float32, device=device))

    gsq = ops.adamw_flat_buckets(pb, gb, mb, vb, lr=lr, beta1=cfg.beta1,
                                 beta2=cfg.beta2, eps=cfg.eps,
                                 weight_decay=cfg.weight_decay, c1=c1, c2=c2,
                                 clip_scale=scale)
    if grad_sqnorm is None:   # kernel byproduct: Σg² with zero extra passes
        grad_sqnorm = gsq
    return pb, mb, vb, count, torch.sqrt(grad_sqnorm), grad_sqnorm


# ------------------------------------------------------- lr schedules ----

def warmup_cosine(step, *, peak_lr: float, min_lr: float, warmup_steps: int,
                  total_steps: int):
    """Linear warmup + cosine decay (the paper's schedule, Table 5), as a
    0-d f32 tensor computed in f32 like the reference."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_lr + 0.5 * (peak_lr - min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant_lr(step, *, peak_lr: float, **_):
    return torch.tensor(peak_lr, dtype=torch.float32)
