"""Gradient noise scale (McCandlish et al. 2018) from norm-test statistics.

The paper's §5.4 conjectures a relation between the norm-test threshold η and
the *critical batch size*.  The GNS B_simple = tr(Σ)/‖∇L‖² is exactly
computable from the two scalars the norm test already produces:

    ‖Var̂‖₁ = (1/J)Σ_j ‖g_j − g‖²  estimates  tr(Σ)/b_worker = tr(Σ)·J/b
    ⇒  tr(Σ) ≈ var_l1 · b / J      and  B_simple = tr(Σ)/‖g‖².

Algorithm 1's growth target is b_{k+1} = ‖Var̂‖₁/(η²‖g‖²) = B_simple/(η²·J/b)…
collapsing the algebra:   b_{k+1} = B_simple / (η² · J) · (J/b) · b … i.e.

    b_{k+1} · η² = B_simple · (J / b_k)        (per-worker form)

so for J = b (per-sample workers) the norm test with threshold η grows the
batch to exactly B_simple/η² — the norm test IS a thresholded
gradient-noise-scale controller.  `examples/gns_tracking.py` demonstrates the
relation empirically; the unbiased running estimator below matches
McCandlish's two-scale trick using (b_small, b_big) = (b/G, b).

Variance groups
---------------
Both step implementations report `var_l1` on the *per-worker* (J) scale, but
the number of independent variance groups the statistic actually averages
over differs: FSDP-Norm compares J worker gradients (G = J), ACCUM-NORM
compares the M accumulation microbatch gradients on each of J workers
(G = M·J).  The two-scale estimator needs the GROUP count — with the old
hardwired `workers` an ACCUM-NORM J=1 run degenerated to b_small == b_big
and silently returned b_simple = 0 (a dead GNS signal).  `variance_groups`
defines the count once; the estimators convert var_l1 from the J scale to
the group scale internally (var_G = var_l1 · G / J).

Prediction
----------
The controller in `core/controller.py` carries a `GNSTracker` to turn the
smoothed B_simple trajectory into (a) an ETA until the norm test next fires
and (b) the ladder rung it will land on — used to AOT-warm the *predicted*
rung instead of blindly the next one (DESIGN §14).  The crossing level
accounts for the noise inflation of the measured ‖G_b‖²:

    T(b) = var_l1/(η²·‖G_b‖²),  var_l1 = tr(Σ)·J/b,  ‖G_b‖² ≈ |G|²(1 + B/b)
    T > b  ⟺  B·(J/b − η²) > η²·b  ⟺  B > η²·b²/(J − η²·b)   when J > η²·b

(and the test can never fire at b when J ≤ η²·b: the measured gradient norm
grows with the noise as fast as the variance does).

Copy of `repro/core/gns.py` (it uses no framework), its logic kept
identical so that the port takes exactly the reference's batch-size
decisions; the tests hold the two to exact equality.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def variance_groups(step_impl: str, workers: int, accum_steps: int = 1) -> int:
    """The number of independent variance groups `var_l1` averages over:
    J for FSDP-Norm (worker gradients), M·J for ACCUM-NORM (accumulation
    microbatch gradients on every worker)."""
    j = max(int(workers), 1)
    if step_impl == "accum_norm":
        return j * max(int(accum_steps), 1)
    return j


def gns_from_norm_test(var_l1: float, grad_sqnorm: float, global_batch: int,
                       workers: int) -> dict:
    """Point estimates of tr(Σ) and B_simple from one step's statistics.
    `workers` is the J scale var_l1 arrives on (NOT the group count — both
    step impls emit var_l1 ≈ tr(Σ)·J/b regardless of grouping)."""
    tr_sigma = float(var_l1) * global_batch / max(workers, 1)
    b_simple = tr_sigma / max(float(grad_sqnorm), 1e-30)
    return {"tr_sigma": tr_sigma, "b_simple": b_simple}


def unbiased_gns_pair(var_l1: float, grad_sqnorm: float, global_batch: int,
                      workers: int, groups: int | None = None) -> dict:
    """McCandlish's unbiased two-batch-size estimator using the variance
    group minibatch (b_small = b/G, its mean-square-norm = ‖g‖² + var_G) and
    the global batch (b_big = b):

        |G|² := (b_big·‖G_big‖² − b_small·‖G_small‖²)/(b_big − b_small)
        S    := (‖G_small‖² − ‖G_big‖²)/(1/b_small − 1/b_big)
        B_simple = S / |G|²

    `groups` is the variance-group count G (`variance_groups`); it defaults
    to `workers` (the FSDP-Norm case, preserving the original signature).
    var_l1 always arrives on the J scale and is converted to the group
    scale internally.  Degenerate inputs — one group (no two-scale signal)
    or a non-positive/non-finite |G|² estimate (noise swamping the mean
    gradient) — return a CLAMPED b_simple of 0.0 with valid=False instead
    of the old silent 0.0 / inf, so downstream smoothing can skip them."""
    g = max(int(groups if groups is not None else workers), 1)
    b_big = float(global_batch)
    b_small = b_big / g
    if g <= 1:
        return {"g2": float(grad_sqnorm), "s": 0.0, "b_simple": 0.0,
                "valid": False}
    var_g = float(var_l1) * g / max(workers, 1)   # J scale -> group scale
    gsmall_sq = float(grad_sqnorm) + var_g   # E‖g_i‖² = ‖g‖² + E‖g_i−g‖²
    gbig_sq = float(grad_sqnorm)
    g2 = (b_big * gbig_sq - b_small * gsmall_sq) / (b_big - b_small)
    s = (gsmall_sq - gbig_sq) / (1.0 / b_small - 1.0 / b_big)
    valid = math.isfinite(g2) and math.isfinite(s) and g2 > 0.0
    return {"g2": g2, "s": s, "b_simple": s / g2 if valid else 0.0,
            "valid": valid}


@dataclass(frozen=True)
class GNSTracker:
    """EMA-smoothed running GNS (McCandlish appendix A.1 recommends separate
    EMAs of S and |G|² rather than of their ratio).  The first VALID
    observation seeds both EMAs (no blend against the 0.0 placeholders);
    degenerate or non-finite estimates are skipped — they never reach the
    smoothed trajectory the predictor fits."""
    alpha: float = 0.9
    s_ema: float = 0.0
    g2_ema: float = 0.0
    initialized: bool = False

    def update(self, var_l1: float, grad_sqnorm: float, global_batch: int,
               workers: int, groups: int | None = None) -> "GNSTracker":
        est = unbiased_gns_pair(var_l1, grad_sqnorm, global_batch, workers,
                                groups=groups)
        if not est["valid"]:
            return self
        if not self.initialized:
            return GNSTracker(self.alpha, est["s"], est["g2"], True)
        a = self.alpha
        return GNSTracker(self.alpha, a * self.s_ema + (1 - a) * est["s"],
                          a * self.g2_ema + (1 - a) * est["g2"], True)

    @property
    def b_simple(self) -> float:
        if not self.initialized or self.g2_ema <= 0:
            return 0.0
        return self.s_ema / self.g2_ema


# ------------------------------------------------------------ prediction ----

def critical_gns_at(batch: int, eta: float, workers: int) -> float:
    """B_cross(b): the smoothed-GNS level above which the norm test fires at
    global batch `b` (module docstring derivation).  inf when J ≤ η²·b —
    the measured gradient norm inflates with the noise, so no noise level
    can fire the test at that rung."""
    denom = float(workers) - eta * eta * float(batch)
    if denom <= 0.0:
        return float("inf")
    return eta * eta * float(batch) ** 2 / denom


def rung_crossing_eta(b_simple: float, slope: float, batch: int, eta: float,
                      workers: int) -> float:
    """Tested-steps until the norm test fires at the current batch: 0.0 when
    the smoothed GNS already exceeds the crossing level, -1.0 when
    unknowable (non-growing GNS, or an uncrossable rung).  The -1.0
    sentinel (not inf/nan) keeps the value exactly JSON-round-trippable
    inside checkpointed controller state."""
    cross = critical_gns_at(batch, eta, workers)
    if b_simple >= cross:
        return 0.0
    if slope <= 0.0 or not math.isfinite(cross):
        return -1.0
    return (cross - b_simple) / slope


def predict_target_batch(b_simple: float, slope: float, horizon: float,
                         batch: int, eta: float, workers: int,
                         rungs) -> int:
    """The ladder rung the controller is headed for: the smallest rung ≥ the
    current batch at which the horizon-projected GNS no longer fires the
    test (B_proj ≤ B_cross), i.e. where the controller would be stable.
    Projection runs the slope forward `horizon` tested steps; a projection
    above every rung's crossing level lands on the top rung.  Returns the
    rung's global batch, or 0 when there is no ladder to predict onto."""
    rungs = sorted(int(r) for r in (rungs or ()))
    if not rungs:
        return 0
    b_proj = b_simple + max(slope, 0.0) * float(horizon)
    for r in rungs:
        if r < batch:
            continue
        if b_proj <= critical_gns_at(r, eta, workers):
            return r
    return rungs[-1]
