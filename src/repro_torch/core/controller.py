"""Algorithm 1: the adaptive batch-size controller (host-side state machine).

Consumes the (var_l1, grad_sqnorm) statistics produced on-device by
`core.norm_test` and decides the next step's `BatchPlan`:

    T_k = ‖Var̂‖₁ / (η² ‖g‖²)
    if T_k > b_k:  b_{k+1} = ⌈T_k⌉  (rounded via `round_plan`, clamped)
    else:          b_{k+1} = b_k

Extras beyond Algorithm 1 (all off by default, recorded in DESIGN §7):
  * test_interval > 1 — run the test every N steps (the paper mentions this
    as the overhead-reduction knob; interval 1 is the paper's setting);
  * EMA smoothing of T_k to de-noise single-step spikes;
  * `monotonic` — never shrink the batch (the paper's test only grows; we
    keep the flag explicit so ablations can allow shrinking).

Copy of `repro/core/controller.py` (it uses no framework), its logic kept
identical so that the port takes exactly the reference's batch-size
decisions; the tests hold the two to exact equality.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace

from repro_torch.core.gns import (
    GNSTracker, predict_target_batch, rung_crossing_eta, variance_groups)
from repro_torch.core.schedule import BatchPlan, quantize_to_ladder, round_plan


@dataclass(frozen=True)
class ControllerConfig:
    eta: float = 0.15
    workers: int = 1
    base_micro_batch: int = 4
    max_micro_batch: int = 8
    base_accum: int = 16
    base_global_batch: int = 256
    max_global_batch: int = 8192
    test_interval: int = 1
    ema: float = 0.0              # 0 = off (paper-faithful)
    monotonic: bool = True
    # optional shape-bucket ladder (DESIGN §8): when set, every emitted plan
    # is quantized UP onto a ladder rung, so a batch increase reuses a
    # precompiled step instead of recompiling; None = paper-exact rounding
    ladder: tuple[BatchPlan, ...] | None = None
    # predictive GNS companion (DESIGN §14): when on, every tested step also
    # feeds the (var_l1, grad_sqnorm) pair into an EMA-smoothed unbiased GNS
    # estimate whose trajectory predicts WHICH rung the controller will jump
    # to and WHEN — carried in ControllerState for the engine's AOT-warmup
    # targeting.  Prediction NEVER alters the batch trajectory: with
    # predict=True and predict=False the emitted plans are identical, which
    # is what lets pre-predictor checkpoints resume bit-identically with a
    # zeroed predictor.
    predict: bool = False
    gns_alpha: float = 0.9        # EMA over the S and |G|² estimates
    # variance-group source for the two-scale estimator: 'workers' = J
    # groups (FSDP-Norm), 'accum' = M·J groups (ACCUM-NORM) — see
    # core.gns.variance_groups
    gns_groups: str = "workers"
    slope_alpha: float = 0.5      # EMA over the per-tested-step ΔB_simple
    predict_horizon: int = 5      # tested-steps lookahead for the target rung


def _resolve_plan(cfg: ControllerConfig, desired: int) -> BatchPlan:
    plan = round_plan(desired, cfg.workers, cfg.base_micro_batch,
                      cfg.max_micro_batch, cfg.base_accum,
                      cfg.max_global_batch)
    if cfg.ladder:
        plan = quantize_to_ladder(plan.global_batch, cfg.ladder,
                                  cfg.max_global_batch)
    return plan


@dataclass(frozen=True)
class ControllerState:
    plan: BatchPlan
    step: int = 0
    samples: int = 0
    ema_stat: float = 0.0
    # whether ema_stat holds a real observation yet.  `state.step > 0` is NOT
    # a valid proxy: with test_interval > 1 the first tested step arrives at
    # step >= 1 with ema_stat still at its 0.0 placeholder, and blending
    # against it biased T toward 0, delaying the first batch increase.
    ema_init: bool = False
    last_T: float = 0.0
    num_increases: int = 0
    at_max: bool = False
    # predictive-GNS companion state (DESIGN §14; all inert defaults unless
    # cfg.predict).  Flat scalars, not a nested GNSTracker, so the JSON
    # checkpoint round-trip stays a plain dict of primitives.
    gns_s: float = 0.0            # EMA of the S (tr Σ) estimate
    gns_g2: float = 0.0           # EMA of the |G|² estimate
    gns_init: bool = False        # EMAs hold a real (valid) observation
    gns_b_prev: float = 0.0       # previous smoothed B_simple (slope input)
    gns_slope: float = 0.0        # EMA of per-tested-step ΔB_simple
    gns_slope_init: bool = False
    pred_rung: int = 0            # predicted target rung (global batch); 0 = none
    pred_eta_steps: float = -1.0  # tested-steps to crossing; -1 = unknown


def init_controller(cfg: ControllerConfig) -> ControllerState:
    return ControllerState(plan=_resolve_plan(cfg, cfg.base_global_batch))


# ------------------------------------------- state (de)serialization ----
#
# The controller is half the training loop's host-side state (the other
# half — params/opt — lives on device): crash-safe checkpointing must
# capture it EXACTLY or a resumed run re-derives a different batch
# trajectory and bit-identity with the uninterrupted run is lost.  JSON
# round-trips Python floats exactly (repr-based shortest form), so
# ema_stat/last_T survive the hop bit-for-bit.

def controller_state_as_dict(state: ControllerState) -> dict:
    """JSON-safe snapshot of the full controller state (checkpoint
    metadata); `controller_state_from_dict` is the exact inverse."""
    return dataclasses.asdict(state)


def controller_state_from_dict(d: dict) -> ControllerState:
    """Rebuild a `ControllerState` saved by `controller_state_as_dict`.

    The predictor fields load with SAFE DEFAULTS when absent (a checkpoint
    written before the predictor existed): prediction only steers AOT-warmup
    targeting, never the batch trajectory, so a zeroed predictor re-seeds
    itself on the next tested step and the resumed run's losses/batches stay
    bit-identical to the uninterrupted one — a loud error would make old
    checkpoints unloadable for zero correctness gain."""
    plan = BatchPlan(**{k: int(v) for k, v in d["plan"].items()})
    return ControllerState(
        plan=plan, step=int(d["step"]), samples=int(d["samples"]),
        ema_stat=float(d["ema_stat"]), ema_init=bool(d["ema_init"]),
        last_T=float(d["last_T"]), num_increases=int(d["num_increases"]),
        at_max=bool(d["at_max"]),
        gns_s=float(d.get("gns_s", 0.0)), gns_g2=float(d.get("gns_g2", 0.0)),
        gns_init=bool(d.get("gns_init", False)),
        gns_b_prev=float(d.get("gns_b_prev", 0.0)),
        gns_slope=float(d.get("gns_slope", 0.0)),
        gns_slope_init=bool(d.get("gns_slope_init", False)),
        pred_rung=int(d.get("pred_rung", 0)),
        pred_eta_steps=float(d.get("pred_eta_steps", -1.0)))


def norm_test_statistic(var_l1: float, grad_sqnorm: float, eta: float) -> float:
    return float(var_l1) / (eta**2 * float(grad_sqnorm) + 1e-30)


def _predictor_fields(cfg: ControllerConfig, state: ControllerState,
                      var_l1: float, grad_sqnorm: float) -> dict:
    """One predictive-GNS update for a TESTED step: smooth the unbiased
    two-scale estimate, fit the slope of the smoothed B_simple, and emit the
    rung-crossing ETA + predicted target rung (DESIGN §14).  Returns the
    full predictor field dict — unchanged copies when cfg.predict is off —
    so both controller_update return paths can splat it."""
    fields = dict(gns_s=state.gns_s, gns_g2=state.gns_g2,
                  gns_init=state.gns_init, gns_b_prev=state.gns_b_prev,
                  gns_slope=state.gns_slope,
                  gns_slope_init=state.gns_slope_init,
                  pred_rung=state.pred_rung,
                  pred_eta_steps=state.pred_eta_steps)
    if not cfg.predict:
        return fields
    groups = variance_groups(
        "accum_norm" if cfg.gns_groups == "accum" else "fsdp_norm",
        state.plan.workers, state.plan.accum_steps)
    tracker = GNSTracker(cfg.gns_alpha, state.gns_s, state.gns_g2,
                         state.gns_init)
    tracker = tracker.update(var_l1, grad_sqnorm, state.plan.global_batch,
                             state.plan.workers, groups=groups)
    fields.update(gns_s=tracker.s_ema, gns_g2=tracker.g2_ema,
                  gns_init=tracker.initialized)
    if not tracker.initialized:
        return fields                 # estimate skipped (degenerate/clamped)
    b_now = tracker.b_simple
    if state.gns_init:                # gns_b_prev holds the previous B
        delta = b_now - state.gns_b_prev
        slope = (cfg.slope_alpha * state.gns_slope
                 + (1 - cfg.slope_alpha) * delta
                 if state.gns_slope_init else delta)   # seed, don't blend
        fields.update(gns_slope=slope, gns_slope_init=True)
    else:
        slope = 0.0
    fields["gns_b_prev"] = b_now
    b_k = state.plan.global_batch
    fields["pred_eta_steps"] = rung_crossing_eta(
        b_now, slope if fields["gns_slope_init"] else 0.0, b_k, cfg.eta,
        cfg.workers)
    rungs = ([min(p.global_batch, cfg.max_global_batch) for p in cfg.ladder
              if p.global_batch <= cfg.max_global_batch]
             if cfg.ladder else None)
    fields["pred_rung"] = predict_target_batch(
        b_now, slope if fields["gns_slope_init"] else 0.0,
        cfg.predict_horizon, b_k, cfg.eta, cfg.workers, rungs)
    return fields


def controller_update(cfg: ControllerConfig, state: ControllerState,
                      var_l1: float, grad_sqnorm: float) -> ControllerState:
    """One Algorithm-1 update after an optimizer step."""
    new_samples = state.samples + state.plan.global_batch
    step = state.step + 1

    # max-batch shortcut: the paper stops testing once b_k == max.  The
    # predictive companion still observes — the (var_l1, gsq) pair arrives
    # free with every step and the at_max latch would otherwise starve the
    # tracker exactly when the GNS trajectory becomes informative.  With
    # cfg.predict off, _predictor_fields returns unchanged copies and this
    # return is bit-identical to the pre-predictor controller.
    if state.at_max or (cfg.test_interval > 1 and step % cfg.test_interval != 0):
        pred = _predictor_fields(cfg, state, var_l1, grad_sqnorm)
        return replace(state, step=step, samples=new_samples, **pred)

    t_raw = norm_test_statistic(var_l1, grad_sqnorm, cfg.eta)
    if cfg.ema > 0:
        ema = cfg.ema * state.ema_stat + (1 - cfg.ema) * t_raw \
            if state.ema_init else t_raw
        t_eff = ema
    else:
        ema = t_raw
        t_eff = t_raw

    # predictive companion: pure observer of the same (var_l1, gsq) pair —
    # it steers warmup targeting, never the plan below
    pred = _predictor_fields(cfg, state, var_l1, grad_sqnorm)

    b_k = state.plan.global_batch
    if t_eff > b_k:
        desired = math.ceil(t_eff)
        if cfg.monotonic:
            desired = max(desired, b_k)
        plan = _resolve_plan(cfg, desired)
        if cfg.monotonic and plan.global_batch < b_k:
            plan = state.plan
        increased = plan.global_batch > b_k
        # the reachable ceiling: the largest ladder rung the cap permits —
        # a ladder whose top rung rounds below max_global_batch still
        # latches there (nothing larger is eligible)
        cap = cfg.max_global_batch
        if cfg.ladder:
            cap = max((p.global_batch for p in cfg.ladder
                       if p.global_batch <= cfg.max_global_batch),
                      default=cfg.ladder[0].global_batch)
        return ControllerState(
            plan=plan, step=step, samples=new_samples, ema_stat=ema,
            ema_init=True, last_T=t_raw,
            num_increases=state.num_increases + int(increased),
            at_max=plan.global_batch >= min(cfg.max_global_batch, cap),
            **pred)
    return replace(state, step=step, samples=new_samples, ema_stat=ema,
                   ema_init=True, last_T=t_raw, **pred)
