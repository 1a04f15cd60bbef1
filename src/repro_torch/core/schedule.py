"""Batch-size schedules: constant, stagewise warmup (the paper's heuristic
baseline, e.g. 2.5–2.5–95%), and the adaptive norm-test schedule (see
controller.py).  All schedules speak the same `BatchPlan` vocabulary:
global batch = workers (J) × accumulation steps (M) × per-worker microbatch.

Copy of `repro/core/schedule.py` (it uses no framework), its logic kept
identical so that the port takes exactly the reference's batch-size
decisions; the tests hold the two to exact equality.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


class LadderShapeError(ValueError):
    """A batch's leading (accum_steps, per-step batch) dims match no ladder
    rung.  Raised by the bucketed engine BEFORE keying the compiled-step
    cache: an off-ladder shape would otherwise trace a fresh executable
    that no warmup covered and no other step will ever hit — the silent
    recompile class the ladder exists to prevent.  Callers must quantize
    through `quantize_to_ladder` + `data.pipeline.pad_to_bucket` first."""


@dataclass(frozen=True)
class BatchPlan:
    """A concrete, launchable batch configuration for one step."""
    global_batch: int
    micro_batch: int     # per-worker, per-accumulation-step sequences
    accum_steps: int     # M
    workers: int         # J

    def __post_init__(self):
        assert self.global_batch == self.workers * self.accum_steps * self.micro_batch, self


def round_plan(desired_global: int, workers: int, micro_batch: int,
               max_micro_batch: int, base_accum: int,
               max_global: int, micro_buckets: bool = True) -> BatchPlan:
    """Algorithm 1's rounding chain, adapted for shape-stable TPU steps.

    The paper fixes M and grows the microbatch (b^M = ⌈b/(JM)⌉); under XLA a
    microbatch-shape change recompiles, so we bucket the microbatch to powers
    of two in [micro_batch, max_micro_batch] and let M absorb the remainder
    (M is a host-side loop count — free to change).  The result satisfies
    b_{k+1} = J·M·b^M ≥ desired, exactly as in Algorithm 1.
    """
    desired = max(1, min(desired_global, max_global))
    # choose the microbatch bucket
    ideal_micro = max(1, math.ceil(desired / (workers * base_accum)))
    if micro_buckets:
        mb = micro_batch
        while mb * 2 <= max_micro_batch and mb * 2 <= ideal_micro:
            mb *= 2
    else:
        mb = min(max(ideal_micro, micro_batch), max_micro_batch)
    m = max(1, math.ceil(desired / (workers * mb)))
    gb = workers * m * mb
    if gb > max_global:
        m = max(1, max_global // (workers * mb))
        gb = workers * m * mb
    return BatchPlan(global_batch=gb, micro_batch=mb, accum_steps=m, workers=workers)


# ------------------------------------------------------- bucket ladder ----

def bucket_ladder(workers: int, micro_batch: int, max_micro_batch: int,
                  base_accum: int, base_global: int,
                  max_global: int) -> tuple[BatchPlan, ...]:
    """Precompute the shape-bucket ladder for the bucketed step engine
    (DESIGN §8): a geometric sequence of `BatchPlan`s whose capacities double
    from the base plan up to (and including) the `max_global` plan.

    Every rung is produced by `round_plan`, so micro-batches are the same
    powers-of-two buckets Algorithm 1's rounding uses and M absorbs the
    remainder.  Consecutive rungs share the micro-batch whenever possible, so
    growing the batch usually changes only the host-side stacked-M dimension.
    """
    rungs: list[BatchPlan] = []
    top = round_plan(max_global, workers, micro_batch, max_micro_batch,
                     base_accum, max_global)
    cap = round_plan(base_global, workers, micro_batch, max_micro_batch,
                     base_accum, max_global).global_batch
    while cap < top.global_batch:
        rungs.append(round_plan(cap, workers, micro_batch, max_micro_batch,
                                base_accum, cap))
        cap *= 2
    rungs.append(top)
    # dedupe (tiny ladders can collapse) keeping capacity order
    seen, out = set(), []
    for p in rungs:
        k = (p.micro_batch, p.accum_steps)
        if k not in seen:
            seen.add(k)
            out.append(p)
    return tuple(out)


def parse_ladder(spec: str, workers: int) -> tuple[BatchPlan, ...]:
    """Parse an explicit `--bucket-ladder` spec: 'micro:accum,micro:accum,...'
    (capacities must be strictly increasing)."""
    rungs = []
    for part in spec.split(","):
        mb, m = (int(v) for v in part.split(":"))
        rungs.append(BatchPlan(global_batch=workers * m * mb, micro_batch=mb,
                               accum_steps=m, workers=workers))
    caps = [p.global_batch for p in rungs]
    if caps != sorted(set(caps)):
        raise ValueError(f"bucket ladder capacities must increase: {caps}")
    return tuple(rungs)


def quantize_to_ladder(desired_global: int, ladder: tuple[BatchPlan, ...],
                       max_global: int | None = None) -> BatchPlan:
    """Smallest ladder rung whose capacity covers `desired_global`.

    With `max_global` set, both the request and the RESULT are capped: rungs
    above `max_global` are ineligible (an explicit --bucket-ladder may hold
    rungs beyond the controller's cap), so once the request exceeds the
    largest eligible rung, that rung is returned.  Never shrinks a request an
    eligible rung can cover.  Degenerate case — every rung above the cap —
    falls back to the smallest rung.

    The scan early-outs on the first rung above the cap, which is only
    correct on an ascending ladder — programmatically-built ladders are not
    guaranteed sorted (`parse_ladder` validates, arbitrary tuples don't), so
    capacities are sorted here before scanning rather than silently skipping
    eligible rungs."""
    desired = desired_global if max_global is None else min(desired_global,
                                                            max_global)
    ladder = tuple(sorted(ladder, key=lambda p: p.global_batch))
    best = None
    for plan in ladder:
        if max_global is not None and plan.global_batch > max_global:
            break                      # capacities ascend: rest ineligible
        best = plan
        if plan.global_batch >= desired:
            return plan
    return best if best is not None else ladder[0]


# ------------------------------------------------------------ schedules ----

class ConstantSchedule:
    """b_k = const (the paper's constant-batch baselines)."""

    def __init__(self, plan: BatchPlan):
        self.plan = plan

    def plan_for(self, samples_processed: int, total_samples: int,
                 stats=None) -> BatchPlan:
        return self.plan


class StagewiseSchedule:
    """Prespecified warmup stages, e.g. 2048–4096–8192 for 2.5–2.5–95% of
    training samples (paper §5.1 baseline mimicking Nemotron-4/GPT-3 ramps).

    Stage sizes round UP to a launchable plan: the old `round_plan(batch,
    ..., max_global=batch)` call shrank a stage whose size was not divisible
    by workers·micro_batch (the cap clamped the rounded-up plan back BELOW
    the prescribed size), and never ladder-quantized — under the bucketed
    engine such a plan's padded shape matched no rung and the run died with
    `LadderShapeError` mid-training.  Pass the engine's ladder to emit rung
    plans directly."""

    def __init__(self, stages: tuple[tuple[float, int], ...], workers: int,
                 micro_batch: int, max_micro_batch: int, base_accum: int,
                 ladder: tuple[BatchPlan, ...] | None = None):
        # stages: ((fraction_of_samples, global_batch), ...) fractions sum to 1
        assert abs(sum(f for f, _ in stages) - 1.0) < 1e-6
        self.stages = stages
        self.workers = workers
        self.micro_batch = micro_batch
        self.max_micro_batch = max_micro_batch
        self.base_accum = base_accum
        self.ladder = ladder

    def plan_for(self, samples_processed: int, total_samples: int,
                 stats=None) -> BatchPlan:
        frac = samples_processed / max(total_samples, 1)
        acc = 0.0
        batch = self.stages[-1][1]
        for f, b in self.stages:
            acc += f
            if frac < acc:
                batch = b
                break
        # no max_global cap: an indivisible stage size must round UP to the
        # covering (J·M·mb) plan, never shrink below the prescribed stage
        plan = round_plan(batch, self.workers, self.micro_batch,
                          self.max_micro_batch, self.base_accum,
                          max_global=_UNCAPPED, micro_buckets=True)
        if self.ladder:
            # quantize onto a rung only AT or ABOVE the ladder floor: a stage
            # below the smallest rung runs padded into the floor bucket (the
            # engine's standard sub-rung path) — inflating it to the floor
            # would consume more samples than the stage prescribes
            floor = min(p.global_batch for p in self.ladder)
            if plan.global_batch >= floor:
                plan = quantize_to_ladder(plan.global_batch, self.ladder)
        return plan


# large enough that round_plan's max_global clamp never engages (stagewise
# rounding must only ever round UP); not sys.maxsize so the math stays exact
_UNCAPPED = 1 << 40


# ------------------------------------------------- accumulation-free ----

def accum_free_plan(plan: BatchPlan) -> tuple[BatchPlan, int]:
    """Re-plan an accumulated step as `accum_steps` optimizer steps of the
    same microbatch with M=1 (Marek et al., "Gradient Accumulation Is
    Wasteful"): on rungs where the whole per-step batch fits per device,
    accumulation buys nothing — trade it for proportionally more optimizer
    steps.  Returns (sub_plan, repeats) with sub_plan.global_batch ·
    repeats == plan.global_batch, so the schedule consumes exactly the same
    samples (DESIGN §14 equivalence claim)."""
    sub = BatchPlan(global_batch=plan.workers * plan.micro_batch,
                    micro_batch=plan.micro_batch, accum_steps=1,
                    workers=plan.workers)
    return sub, plan.accum_steps
