"""The paper's core contribution, the (approximate) norm test, eq. (3)/(5)
(counterpart of `repro/core/norm_test.py`).  Each estimator returns the
pair (var_l1, grad_sqnorm) from which the controller computes
T_k = var_l1 / (η² · grad_sqnorm):

* `per_sample_norm_test` — eq. (3): exact per-sample gradients through
  `torch.func.vmap(torch.func.grad(...))` (single-device / validation
  scale only; the paper explains why this is impractical at LLM scale).
* `worker_variance_stats` and its flat-buffer forms — eq. (5)
  DDP-/FSDP-Norm: the variance of the J workers' minibatch gradients.  A
  worker is a `torch.distributed` rank (`launch/mesh.py`); where the
  reference reduces over the mesh's data axes (`psum`, `pmean`), the port
  all-reduces over the data group (`group`; default: every rank).  With
  one worker there is no group and no collective.  Under a model axis the
  caller passes each rank's leaves with every replicated leaf on one rank
  only, and `model_group` sums the pieces.
* `accum_variance_stats` — beyond-paper ACCUM-NORM: variance across the M
  gradient-accumulation microbatch gradients, rescaled onto the per-worker
  minibatch scale of eq. (5).

`exact_variance_test_holds` is the exact-variance test (eq. 4) on
materialized per-sample gradients, used to validate the estimators.

The statistics stay 0-d tensors on the device: nothing here reads a value
on the host.  All reductions are float32 regardless of gradient dtype.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import SELF, pmean, psum
from repro_torch.tree import tree_leaves, tree_map


def tree_sqnorm(tree) -> torch.Tensor:
    """Σ ‖x‖² over all leaves, in f32."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else "cpu")
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return total


def tree_sqdiff(tree_a, tree_b) -> torch.Tensor:
    """Σ ‖a − b‖² over all leaves, in f32 (the plain form of the
    `sqdiff_norm` kernel's statistic)."""
    la, lb = tree_leaves(tree_a), tree_leaves(tree_b)
    acc = torch.zeros((), dtype=torch.float32,
                      device=la[0].device if la else "cpu")
    for a, b in zip(la, lb):
        acc = acc + torch.sum(torch.square(a.float() - b.float()))
    return acc


# ------------------------------------------------------- eq. (3) exact ----

def per_sample_norm_test(loss_fn, params, batch, eta: float):
    """Vanilla norm test (eq. 3) with exact per-sample gradients via vmap.

    loss_fn(params, single_example_batch) -> 0-d tensor; `batch` is a
    tensor or a tree of tensors with a leading example axis.  Returns
    dict(T, lhs_over_b, var_l1, grad_sqnorm, grad), `grad` the mean
    gradient tree."""
    b = tree_leaves(batch)[0].shape[0]
    per_sample = torch.func.vmap(torch.func.grad(loss_fn),
                                 in_dims=(None, 0))(params, batch)
    mean_grad = tree_map(lambda g: torch.mean(g, dim=0), per_sample)

    # ‖Var_i(∇ℓ_i)‖₁ = 1/(b-1) Σ_i ‖∇ℓ_i − ∇L_B‖²  (sum over coordinates)
    def var_leaf(ps, m):
        d = ps.float() - m.float()[None]
        return torch.sum(torch.square(d)) / max(b - 1, 1)

    terms = tree_leaves(tree_map(var_leaf, per_sample, mean_grad))
    var_l1 = torch.zeros((), dtype=torch.float32, device=terms[0].device)
    for t in terms:
        var_l1 = var_l1 + t
    gsq = tree_sqnorm(mean_grad)
    stat = var_l1 / b / (eta**2 * gsq + 1e-30)
    return {"T": var_l1 / (eta**2 * gsq + 1e-30), "lhs_over_b": stat,
            "var_l1": var_l1, "grad_sqnorm": gsq, "grad": mean_grad}


# ------------------------------------------- eq. (5) DDP-/FSDP-Norm ----

def worker_variance_stats(local_grad, mean_grad, *, sqdiff_fn=None,
                          group=None, model_group=SELF):
    """Per-worker statistic from this worker's minibatch gradient g_j
    (`local_grad`) and the workers' mean gradient g (`mean_grad`), trees.
    Returns (var_l1, grad_sqnorm): ‖Var̂‖₁ = (1/J)Σ_j‖g_j − g‖² and ‖g‖².

    The local ‖g_j − g‖² is reduced to ONE f32 scalar before the collective
    — the beyond-paper wire-cost optimization (4 bytes vs O(d); DESIGN
    §7.1).  `sqdiff_fn` computes that local sum (default `tree_sqdiff`;
    `kernels.ops.sqdiff_norm_tree` runs the `sqdiff_norm` kernel)."""
    sqdiff = sqdiff_fn or tree_sqdiff
    var_l1 = pmean(psum(sqdiff(local_grad, mean_grad), model_group),
                   group)
    return var_l1, psum(tree_sqnorm(mean_grad), model_group)


def worker_variance_stats_flat(local_grad, mean_grad, *, layout=None,
                               group=None):
    """Flat-buffer variant of `worker_variance_stats` (DESIGN §9): both trees
    are packed into the layout's buckets and the fused-stats kernel computes
    ‖g_j − g‖² AND ‖g‖² in ONE read of each bucket.  `layout` is the step's
    shared `FlatLayout` (rebuilt here when omitted).  Returns (var_l1,
    grad_sqnorm, mean_buffers): the packed mean gradient feeds the AdamW
    tail, so it is packed exactly once per step."""
    from repro_torch.distributed.flatbuf import FlatLayout
    if layout is None:
        layout = FlatLayout.from_tree(mean_grad)
    local_b = layout.flatten(local_grad)
    mean_b = layout.flatten(mean_grad)
    var_l1, gsq = worker_variance_stats_buffers(local_b, mean_b, group=group)
    return var_l1, gsq, mean_b


def worker_variance_stats_buffers(local_buffers, mean_buffers, *, group=None):
    """Born-flat variant (DESIGN §10): g_j and g already live as bucket
    buffers, so this performs no pack — one `ops.stats_flat_buckets` call
    over every bucket (on the card one `fused_stats` launch per dtype
    group).  Shard padding is zero in every gradient buffer and adds
    nothing to either sum.  Returns (var_l1, grad_sqnorm)."""
    from repro_torch.kernels import ops
    local_sq, gsq = ops.stats_flat_buckets(local_buffers, mean_buffers)
    return pmean(local_sq, group), gsq


def paper_faithful_worker_variance(local_grad, mean_grad, *, group=None,
                                   model_group=SELF):
    """The paper's literal formulation: all-reduce the full (g_j − g)² vector
    (eq. 5 computes Var̂ as a d-vector, then takes ‖·‖₁).  Mathematically
    identical to `worker_variance_stats`; kept as the baseline for the
    collective-bytes comparison."""
    diff_sq = tree_map(lambda a, b: torch.square(a.float() - b.float()),
                       local_grad, mean_grad)
    var_vec = tree_map(lambda x: pmean(x, group), diff_sq)
    var_l1 = tree_sqnorm(tree_map(torch.sqrt, var_vec))   # ‖Var̂‖₁ = Σ coords
    return (psum(var_l1, model_group),
            psum(tree_sqnorm(mean_grad), model_group))


# --------------------------------------------- beyond-paper ACCUM-NORM ----

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


# ----------------------------------------------------- exact variance ----

def exact_variance_test_holds(per_sample_grads, eta: float) -> torch.Tensor:
    """The exact-variance norm test (eq. 4) on materialized per-sample
    gradients (a tree, leading sample axis) — used to validate the
    estimators and Proposition 1's E-SG bound.  A 0-d bool tensor."""
    mean = tree_map(lambda g: torch.mean(g, dim=0), per_sample_grads)
    b = tree_leaves(per_sample_grads)[0].shape[0]

    def dev(ps, m):
        d = ps.float() - m.float()[None]
        return torch.sum(torch.square(d)) / b   # E‖g_B − ∇L‖² for b=1 draws / b

    terms = tree_leaves(tree_map(dev, per_sample_grads, mean))
    lhs = torch.zeros((), dtype=torch.float32, device=terms[0].device)
    for t in terms:
        lhs = lhs + t
    return lhs / b <= eta**2 * tree_sqnorm(mean)
