"""Admission/batching controller for the serving tier (DESIGN §11) — a
copy of `repro/core/serve_controller.py`, which uses no framework; the
decisions are the same.

The serving analog of Algorithm 1 (`core.controller`): where the training
controller adapts the batch size to the measured gradient noise
(T_k vs b_k), this one adapts the active request-batch RUNG to the measured
load.  Same vocabulary, same shape discipline: decisions land on a
powers-of-two ladder so every rung change is a precompiled-step lookup in
the serve engine, never a recompile.

Inputs per decision (one decision per engine step):
  * demand  = in-flight + queued requests — the serving counterpart of the
    norm-test statistic: it says how big the batch WANTS to be;
  * a per-rung step-latency EMA — measured, not modeled, mirroring how the
    training side trusts measured dynamics over static schedules.  Growth
    into a rung whose measured step time already exceeds the latency budget
    is vetoed (bigger batches raise throughput but stretch every in-flight
    token's step clock).

Hysteresis: growth is eager (patience 1 by default — queued requests are
waiting), shrink requires `shrink_patience` consecutive slack decisions so a
burst trough doesn't thrash the rung.  Both mirrors of the training
controller's monotone-growth bias, adapted to a workload that does drain.

The per-rung latency EMA carries an explicit initialized flag per rung —
the training controller's cold-start lesson (its `state.step > 0` proxy
blended the first real observation against a 0.0 placeholder and delayed
the first increase; see ControllerState.ema_init).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def serve_ladder(max_batch: int) -> tuple[int, ...]:
    """Powers-of-two request-batch rungs 1, 2, 4, ... up to (and including)
    `max_batch`; a non-power-of-two cap becomes the explicit top rung."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    rungs = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch)
    return tuple(rungs)


def quantize_batch(desired: int, ladder: tuple[int, ...]) -> int:
    """Smallest rung covering `desired` (the top rung when nothing does)."""
    for b in ladder:
        if b >= desired:
            return b
    return ladder[-1]


@dataclass(frozen=True)
class ServeControllerConfig:
    ladder: tuple[int, ...]          # ascending request-batch rungs
    grow_patience: int = 1           # consecutive over-demand decisions
    shrink_patience: int = 4         # consecutive slack decisions
    latency_slo_s: float = 0.0       # per-step budget; 0 disables the guard
    ema: float = 0.5                 # per-rung step-latency EMA weight

    def __post_init__(self):
        caps = list(self.ladder)
        if not caps or caps != sorted(set(caps)) or caps[0] < 1:
            raise ValueError(
                f"serve ladder must be ascending positive rungs: {caps}")
        if self.grow_patience < 1 or self.shrink_patience < 1:
            raise ValueError("patience values must be >= 1")


@dataclass(frozen=True)
class ServeControllerState:
    rung: int = 0                    # index into cfg.ladder
    decisions: int = 0
    grow_streak: int = 0
    shrink_streak: int = 0
    rung_changes: int = 0
    latency_vetoes: int = 0          # growths blocked by the latency guard
    # per-rung measured step latency: EMA value + explicit initialized flag
    lat_ema: tuple[float, ...] = ()
    lat_init: tuple[bool, ...] = ()


def init_serve_controller(cfg: ServeControllerConfig) -> ServeControllerState:
    n = len(cfg.ladder)
    return ServeControllerState(lat_ema=(0.0,) * n, lat_init=(False,) * n)


def observe_step_latency(cfg: ServeControllerConfig,
                         state: ServeControllerState,
                         rung: int, step_time_s: float) -> ServeControllerState:
    """Fold one measured engine-step wall time into that rung's EMA.  The
    first observation SEEDS the EMA (explicit init flag — never blended
    against the 0.0 placeholder)."""
    ema = list(state.lat_ema)
    init = list(state.lat_init)
    ema[rung] = (cfg.ema * ema[rung] + (1 - cfg.ema) * step_time_s
                 if init[rung] else step_time_s)
    init[rung] = True
    return replace(state, lat_ema=tuple(ema), lat_init=tuple(init))


def serve_controller_update(cfg: ServeControllerConfig,
                            state: ServeControllerState,
                            *, queued: int, active: int) -> ServeControllerState:
    """One admission decision: pick the rung the NEXT engine step runs at.

    Grow when demand exceeds the current rung's capacity for
    `grow_patience` consecutive decisions and the target rung's measured
    latency (when known) fits the SLO; shrink when demand fits entirely in
    the next-lower rung for `shrink_patience` consecutive decisions.
    Demand includes the in-flight requests, so a shrink never cuts below
    the active batch."""
    demand = queued + active
    rung = state.rung
    cap = cfg.ladder[rung]
    decisions = state.decisions + 1

    if demand > cap and rung + 1 < len(cfg.ladder):
        grow_streak = state.grow_streak + 1
        if grow_streak >= cfg.grow_patience:
            target = rung + 1
            if (cfg.latency_slo_s > 0 and state.lat_init[target]
                    and state.lat_ema[target] > cfg.latency_slo_s):
                return replace(state, decisions=decisions,
                               grow_streak=grow_streak, shrink_streak=0,
                               latency_vetoes=state.latency_vetoes + 1)
            return replace(state, rung=target, decisions=decisions,
                           grow_streak=0, shrink_streak=0,
                           rung_changes=state.rung_changes + 1)
        return replace(state, decisions=decisions, grow_streak=grow_streak,
                       shrink_streak=0)

    if rung > 0 and demand <= cfg.ladder[rung - 1]:
        shrink_streak = state.shrink_streak + 1
        if shrink_streak >= cfg.shrink_patience:
            return replace(state, rung=rung - 1, decisions=decisions,
                           grow_streak=0, shrink_streak=0,
                           rung_changes=state.rung_changes + 1)
        return replace(state, decisions=decisions, grow_streak=0,
                       shrink_streak=shrink_streak)

    return replace(state, decisions=decisions, grow_streak=0, shrink_streak=0)


__all__ = [
    "ServeControllerConfig", "ServeControllerState", "init_serve_controller",
    "observe_step_latency", "serve_controller_update", "serve_ladder",
    "quantize_batch",
]
