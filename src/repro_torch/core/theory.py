"""Testable consequences of the paper's convergence theory (§4, Appendix B)
(counterpart of `repro/core/theory.py`).

The paper proves convergence of Adam under the *coordinate-wise exact
variance norm test* (Proposition 1 ⇒ coordinate-wise E-SG), with a
feasibility condition on (β₁, β₂).  The checkable pieces:

* `coordinate_norm_test_holds` — the coordinate-wise exact-variance test on
  materialized per-sample gradients (eq. in Prop. 1's premise);
* `esg_constant` — the empirical coordinate-wise E-SG constant
  max_i E[(∂_i L_B)²] / (∂_i L)², which Prop. 1 bounds by 1+η²;
* `adam_beta_condition` — Theorem 1's sufficient condition
  0 < β₁ ≤ √β₂ − 8(1+η²)(1−β₂)/β₂².  With the paper's own training
  hyperparameters (β₁, β₂) = (0.9, 0.95) and any η the sufficient
  condition is violated (√0.95 − 8(1+η²)·0.05/0.9025 ≈ 0.53 − 0.44η² <
  0.9): the theorem's constants are conservative relative to practice.

Per-sample gradients come as a tree of tensors with a leading sample axis
(`torch.func.vmap(torch.func.grad(...))`, as in `core/norm_test.py`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_leaves


def per_coordinate_stats(per_sample_grads):
    """(mean gradient, unbiased per-coordinate variance), both flattened
    over every leaf, in f32."""
    flat = torch.cat([g.reshape(g.shape[0], -1).float()
                      for g in tree_leaves(per_sample_grads)], dim=1)  # (n, d)
    return torch.mean(flat, dim=0), torch.var(flat, dim=0, correction=1)


def coordinate_norm_test_holds(per_sample_grads, eta: float, batch_size: int):
    """Coordinate-wise exact-variance norm test: for every coordinate i,
    E[(∂_i L_B − ∂_i L)²] = Var_i / b ≤ η² (∂_i L)²."""
    mean, var = per_coordinate_stats(per_sample_grads)
    lhs = var / batch_size
    rhs = eta**2 * torch.square(mean)
    return torch.all(lhs <= rhs + 1e-12)


def esg_constant(per_sample_grads, batch_size: int):
    """Empirical coordinate-wise E-SG constant:
    max_i E[(∂_i L_B)²] / (∂_i L)²  (Prop. 1: ≤ 1+η² under the test)."""
    mean, var = per_coordinate_stats(per_sample_grads)
    second = torch.square(mean) + var / batch_size
    denom = torch.square(mean)
    ratio = torch.where(denom > 1e-20, second / torch.clamp(denom, min=1e-20),
                        torch.ones_like(denom))
    return torch.max(ratio)


def adam_beta_condition(beta1: float, beta2: float, eta: float) -> dict:
    """Theorem 1's sufficient condition on (β₁, β₂): returns the bound and
    whether it holds."""
    bound = math.sqrt(beta2) - 8.0 * (1.0 + eta**2) * (1.0 - beta2) / beta2**2
    return {"beta1_bound": bound, "holds": 0.0 < beta1 <= bound}


def minimal_batch_for_coordinate_test(per_sample_grads, eta: float):
    """Smallest b such that the coordinate-wise exact-variance test holds
    (the quantity Algorithm 1 implicitly targets): b* = max_i Var_i/(η²·g_i²)."""
    mean, var = per_coordinate_stats(per_sample_grads)
    denom = eta**2 * torch.square(mean)
    b = torch.where(denom > 1e-20, var / torch.clamp(denom, min=1e-20),
                    torch.zeros_like(denom))
    return torch.ceil(torch.max(b))
