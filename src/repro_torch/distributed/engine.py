"""Bucketed step engine over the batch-size ladder (a reduced counterpart of
`repro/distributed/engine.py`, DESIGN §8).

The reference compiles one XLA executable per ladder rung and caches it, so
that a controller-driven batch increase never recompiles.  Eager PyTorch
compiles nothing: one step function serves every rung.  What the engine
still does here is the rung discipline — quantize a requested plan onto the
ladder, reject off-ladder batch shapes with `LadderShapeError`, and account
padding, hits and rung transitions in `EngineStats`.  `compiles`,
`warmups`, `barriers` and `disk_cache_hits` therefore stay 0.

Ahead-of-time warmup, multi-host coordination and the persistent compile
cache have no eager counterpart yet; they arrive with the coordination
slice and raise `NotImplementedError` until then.

`RungCache` is the subset of the reference's rung cache that the serving
engine stands on: a keyed cache of built steps with lookup-or-build,
warm-up and the counters.  The reference compiles a rung's executable
ahead of time on a background thread; eager PyTorch has nothing to
compile, so a rung's build is its step closure and a warm-up builds it at
once, in the foreground.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.schedule import BatchPlan, LadderShapeError, quantize_to_ladder


@dataclass
class EngineStats:
    """Counters emitted into the run's history (same keys as the
    reference's `EngineStats.as_dict`)."""
    compiles: int = 0          # rung builds (RungCache); 0 for the train engine
    hits: int = 0              # steps whose signature was seen before
    warmups: int = 0
    warmup_failures: int = 0
    warmup_retries: int = 0
    steps: int = 0
    real_samples: int = 0
    padded_samples: int = 0
    buckets_used: list = field(default_factory=list)
    transitions: int = 0       # steps whose signature differs from the last
    transition_hits: int = 0   # ...and was seen before
    barriers: int = 0
    barrier_wait_s: float = 0.0
    desyncs: int = 0
    coord_downgrades: int = 0
    disk_cache_hits: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.steps if self.steps else 0.0

    @property
    def padding_waste(self) -> float:
        total = self.real_samples + self.padded_samples
        return self.padded_samples / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "compiles": self.compiles,
            "hits": self.hits,
            "warmups": self.warmups,
            "warmup_failures": self.warmup_failures,
            "warmup_retries": self.warmup_retries,
            "steps": self.steps,
            "hit_rate": round(self.hit_rate, 4),
            "padding_waste": round(self.padding_waste, 4),
            "buckets_used": list(self.buckets_used),
            "transitions": self.transitions,
            "transition_hits": self.transition_hits,
            "barriers": self.barriers,
            "barrier_wait_s": round(self.barrier_wait_s, 4),
            "desyncs": self.desyncs,
            "coord_downgrades": self.coord_downgrades,
            "disk_cache_hits": self.disk_cache_hits,
        }


def _batch_key(batch) -> tuple:
    """The step signature: names x shapes x dtypes."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


class RungCache:
    """Keyed cache of built steps (the serving engine's base).  A subclass
    supplies `_build(build_arg)`.  `stats.compiles` counts builds,
    `stats.hits` lookups that found the key built, `stats.warmups` builds
    made ahead of use (only with `aot=True`)."""

    def __init__(self, *, aot: bool = False, stats=None):
        self._aot = bool(aot)
        self._cache: dict[tuple, object] = {}
        self.stats = stats if stats is not None else EngineStats()

    def _build(self, build_arg):
        """Build the step of one key (subclass hook)."""
        raise NotImplementedError

    def lookup(self, key: tuple, build_arg):
        """The step for `key`, built at most once per key."""
        fn = self._cache.get(key)
        if fn is not None:
            self.stats.hits += 1
            return fn
        fn = self._cache[key] = self._build(build_arg)
        self.stats.compiles += 1
        return fn

    def cached(self, key: tuple) -> bool:
        """True when `key`'s step is already built."""
        return key in self._cache

    def submit_warmup(self, key: tuple, build_arg) -> bool:
        """Build `key`'s step ahead of use; no-op (False) when warm-up is
        off or the key is built."""
        if not self._aot or key in self._cache:
            return False
        self._cache[key] = self._build(build_arg)
        self.stats.warmups += 1
        self.stats.compiles += 1
        return True


class BucketedEngine:
    """Rung discipline for the eager train step over a bucket ladder.

    wrap   : the step factory returned by `make_accum_norm_step`.
    ladder : tuple[BatchPlan] from `core.schedule.bucket_ladder`."""

    def __init__(self, wrap, ladder: tuple[BatchPlan, ...], *,
                 aot_warmup: bool = False, coordinator=None,
                 persistent_cache_dir: str | None = None):
        if not ladder:
            raise ValueError("bucket ladder must have at least one rung")
        if aot_warmup or coordinator is not None or persistent_cache_dir:
            raise NotImplementedError(
                "AOT warmup, coordination and the compile cache arrive with "
                "the coordination slice")
        self._wrap = wrap
        self.ladder = tuple(sorted(ladder, key=lambda p: p.global_batch))
        self.stats = EngineStats()
        self._seen: set = set()
        self._last_key = None

    def bucket_for(self, desired_global: int,
                   max_global: int | None = None) -> BatchPlan:
        return quantize_to_ladder(desired_global, self.ladder, max_global)

    def check_on_ladder(self, batch):
        """Reject a batch whose leading (M, B) dims match no ladder rung."""
        rungs = sorted({(p.accum_steps, p.workers * p.micro_batch)
                        for p in self.ladder})
        for name in sorted(batch):
            v = batch[name]
            if len(getattr(v, "shape", ())) < 2:
                continue
            lead = tuple(v.shape[:2])
            if lead not in rungs:
                raise LadderShapeError(
                    f"batch leaf {name!r} has leading (M, B) dims {lead}, "
                    f"matching no ladder rung {rungs}; quantize the plan "
                    f"with bucket_for() and pad with pad_to_bucket() before "
                    f"stepping")

    def get_step(self, batch):
        """The step for this (padded) batch; off-ladder shapes raise
        `LadderShapeError`."""
        self.check_on_ladder(batch)
        key = _batch_key(batch)
        if key != self._last_key:
            if self._last_key is not None:
                self.stats.transitions += 1
                self.stats.transition_hits += int(key in self._seen)
            self._last_key = key
        if key in self._seen:
            self.stats.hits += 1
        self._seen.add(key)
        return self._wrap(batch)

    def observe(self, plan: BatchPlan, bucket: BatchPlan):
        """Record one executed step's padding accounting."""
        self.stats.steps += 1
        self.stats.real_samples += plan.global_batch
        self.stats.padded_samples += bucket.global_batch - plan.global_batch
        tag = f"{bucket.micro_batch}x{bucket.accum_steps}"
        if tag not in self.stats.buckets_used:
            self.stats.buckets_used.append(tag)


__all__ = ["BucketedEngine", "EngineStats", "LadderShapeError", "RungCache"]
