"""The paper's core contribution, the (approximate) norm test — the estimators
the port has so far (counterpart of `repro/core/norm_test.py`).

* `accum_variance_stats` — beyond-paper ACCUM-NORM: variance across the M
  gradient-accumulation microbatch gradients, rescaled onto the per-worker
  minibatch scale of eq. (5).

The worker-variance family (eq. 5 DDP-/FSDP-Norm) arrives with the
FSDP-Norm slice.  All reductions are float32 regardless of gradient dtype.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def tree_sqnorm(tree) -> torch.Tensor:
    """Σ ‖x‖² over all leaves, in f32."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else "cpu")
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return total


def accum_variance_stats(micro_grads_sq_sum, mean_grad, num_micro,
                         workers: int, *, gsq=None):
    """Estimate the per-*minibatch* gradient variance from the M accumulation
    microbatch gradients.

    V_m = (1/(M-1)) (Σ_m‖ĝ^m‖² − M‖g‖²) ≈ tr(Σ_ps)·M/b; the paper's eq.(5)
    statistic targets tr(Σ_ps)·J/b, hence the rescale by J/M.

    micro_grads_sq_sum : Σ_m ‖ĝ^m‖² (f32 scalar tensor)
    mean_grad          : the averaged gradient g (tree), unused when `gsq`
                         is given
    num_micro          : number of contributing microbatches — an int or a
                         0-d tensor (fully padded microbatches excluded)
    gsq                : precomputed ‖g‖² (e.g. the flat AdamW kernel's
                         byproduct) — skips the tree_sqnorm pass
    """
    if gsq is None:
        gsq = tree_sqnorm(mean_grad)
    m = torch.as_tensor(num_micro, dtype=torch.float32).to(gsq.device)
    v_m = (micro_grads_sq_sum - m * gsq) / torch.clamp(m - 1, min=1.0)
    v_m = torch.clamp(v_m, min=0.0)
    # single microbatch -> no within-step variance signal
    var_l1 = torch.where(m > 1, v_m * (workers / torch.clamp(m, min=1.0)),
                         torch.zeros_like(v_m))
    return var_l1, gsq
