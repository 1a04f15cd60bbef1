"""Bucketed step engine over the batch-size ladder (counterpart of
`repro/distributed/engine.py`, DESIGN §8).

Algorithm 1 grows the global batch mid-training.  The engine makes a
controller-driven batch increase a dictionary lookup:

* a precomputed **ladder** of shape buckets (`core.schedule.bucket_ladder`);
* **quantization**: a requested `BatchPlan` maps to the smallest rung that
  covers it; off-ladder batch shapes raise `LadderShapeError`;
* a keyed **cache of built steps**, one a (rung, seq_len, extra-input)
  signature for the whole run (`RungCache`);
* optional **ahead-of-time warm-up** of the next rung on a background
  worker, so the first step after an increase finds its step built;
* optional **multi-host coordination** (`coordination.py`): rung-entry
  barriers, leader-decided warm-up agreement and a failure broadcast that
  downgrades the whole fleet to the synchronous build coherently;
* the **persistent compile cache**: restarted or late-joining workers load
  the kernels' libraries from disk instead of running nvcc.

What a rung's entry is: the reference compiles an XLA executable of the
whole step.  Here a training rung's build is the step builder's eager
closure (one closure serves every shape; the training step stays eager);
a serving rung's is a captured CUDA graph on the card
(`serve_engine.ServeEngine`).  The cache, the worker, the retries, the
failure accounting and the counters are the reference's either way.
"""

from __future__ import annotations

import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple

from repro_torch.core.schedule import BatchPlan, LadderShapeError, quantize_to_ladder
from repro_torch.distributed.coordination import disk_cache_hits, enable_persistent_cache
from repro_torch.testing.faults import fault_point


@dataclass
class EngineStats:
    """Counters emitted into the run's history (the reference's keys).

    `compiles`/`warmups` count COMPLETED builds only — a queued warm-up
    increments them when (and only when) its build succeeds; failures land
    in `warmup_failures` and are re-raised by `drain()`."""
    compiles: int = 0          # rung builds (foreground and warm-up)
    hits: int = 0              # lookups that found the rung built
    warmups: int = 0           # rungs built ahead of use
    warmup_failures: int = 0   # warm-up builds that PERMANENTLY failed
    warmup_retries: int = 0    # transient warm-up attempts retried
    steps: int = 0
    real_samples: int = 0
    padded_samples: int = 0
    buckets_used: list = field(default_factory=list)
    transitions: int = 0       # steps whose signature differs from the last
    transition_hits: int = 0   # ...and found it built or being warmed
    barriers: int = 0          # rung-entry barriers crossed
    barrier_wait_s: float = 0.0   # seconds THIS host waited for the fleet
    desyncs: int = 0           # local warm-up proposal != fleet agreement
    coord_downgrades: int = 0  # queued warm-ups dropped on a remote failure
    disk_cache_hits: int = 0   # kernel libraries loaded from the disk cache

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


class ShapeSpec(NamedTuple):
    """A batch leaf's shape and dtype (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: object


def _batch_key(batch_like) -> tuple:
    """The step signature: names x shapes x dtypes."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in batch_like.items()))


def _spec(batch) -> dict:
    return {k: ShapeSpec(tuple(v.shape), v.dtype) for k, v in batch.items()}


def _key_tag(key: tuple) -> str:
    """Short, deterministic, filesystem-safe digest of a cache key — the
    vocabulary the coordinator speaks (barrier names, failure tags)."""
    return f"{zlib.crc32(repr(key).encode()) & 0xFFFFFFFF:08x}"


def _plan_tag(plan: BatchPlan | None) -> str:
    """Warm-up agreement payload: a rung identity, or 'none' at the top."""
    return "none" if plan is None else f"{plan.micro_batch}x{plan.accum_steps}"


class RungCache:
    """The shared rung-cache and warm-up core (DESIGN §8/§11).

    A keyed cache of built steps with (a) a per-key build rendezvous —
    concurrent callers of one key produce exactly ONE build — and (b) a
    single-worker warm-up pool with exactly-once failure accounting.  The
    training `BucketedEngine` and the serving `ServeEngine` subclass it; a
    subclass supplies `_build` (the foreground build of a key's argument)
    and `_aot_build` (the warm-up build, run on the worker).

    Every `_cache`/`_pending`/`_building` access happens under `_lock`; the
    blocking waits (a pending warm-up's `result()`, the build itself)
    happen outside it.

    A warm-up build that raises is retried up to `warmup_retries` times
    with exponential backoff (`warmup_backoff_s`, doubling) before it is
    PERMANENT; only then does `_on_warmup_build_failure` fire (under
    coordination it broadcasts the failure fleet-wide)."""

    def __init__(self, *, aot: bool = False, stats=None,
                 warmup_retries: int = 2, warmup_backoff_s: float = 0.05):
        self._aot = bool(aot)
        self._cache: dict[tuple, object] = {}     # ALL access under _lock
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1) if self._aot else None
        self._pending: dict[tuple, Future] = {}   # key -> warm-up Future
        self._building: dict[tuple, Future] = {}  # key -> foreground build
        self._warmup_errors: list[Exception] = []
        self._warmup_retries = max(0, int(warmup_retries))
        self._warmup_backoff_s = warmup_backoff_s
        self.stats = stats if stats is not None else EngineStats()

    # ------------------------------------------------------------- hooks --

    def _build(self, build_arg):
        """Foreground build of one key (subclass hook)."""
        raise NotImplementedError

    def _aot_build(self, build_arg):
        """Warm-up build of one key, on the worker (subclass hook); only
        called when the cache was constructed with aot=True."""
        raise NotImplementedError

    def _on_warmup_build_failure(self, key: tuple):
        """Called on the worker the moment a warm-up fails for good
        (before the failure is consumed); coordination hook."""

    # ------------------------------------------------------------- cache --

    def lookup(self, key: tuple, build_arg):
        """The built step for `key`; built at most once per key across the
        run, even with concurrent callers.  A warm-up that failed is
        recorded (re-raised by `drain()`) and the call builds in the
        foreground instead."""
        with self._lock:
            fut = self._pending.pop(key, None)
        if fut is not None:
            try:
                fn = fut.result()  # the warm-up finished, or finishes now
            except Exception as e:               # noqa: BLE001 — surfaced in drain()
                self._record_warmup_failure(e, key)
            else:
                with self._lock:
                    self._cache.setdefault(key, fn)
        while True:
            with self._lock:
                fn = self._cache.get(key)
                if fn is not None:
                    self.stats.hits += 1
                    return fn
                bfut = self._building.get(key)
                if bfut is None:
                    bfut = self._building[key] = Future()
                    mine = True
                else:
                    mine = False
            if mine:
                try:
                    fault_point("engine.compile", key=key)
                    fn = self._build(build_arg)
                except BaseException as e:
                    with self._lock:
                        self._building.pop(key, None)
                    bfut.set_exception(e)
                    raise
                with self._lock:
                    self._cache[key] = fn
                    self._building.pop(key, None)
                    self.stats.compiles += 1
                bfut.set_result(fn)
                return fn
            # another caller owns the build: wait, then look again (on its
            # failure, loop around and build here).  Only the builder's
            # failure is absorbed; an interrupt in THIS thread escapes.
            try:
                bfut.result()
            except Exception:                  # noqa: BLE001 — builder raised
                pass

    def cached(self, key: tuple) -> bool:
        """True when `key`'s step is built (no build or warm-up wait would
        be paid to use it)."""
        with self._lock:
            return key in self._cache

    # ------------------------------------------------------- AOT warm-up --

    def submit_warmup(self, key: tuple, build_arg) -> bool:
        """Queue a warm-up build of `key`; no-op (False) when warm-up is off
        or the key is built or pending.  The stats count it on COMPLETION,
        inside the worker."""
        if not self._aot:
            return False
        with self._lock:
            if key in self._cache or key in self._pending:
                return False
            self._pending[key] = self._pool.submit(self._warm, build_arg, key)
        return True

    def _warm(self, build_arg, key):
        attempt = 0
        while True:
            try:
                fault_point("engine.warmup_compile", key=key, attempt=attempt)
                built = self._aot_build(build_arg)
                break
            except Exception:
                # transient until proven otherwise: bounded retries with
                # backoff BEFORE the permanent-failure hook
                if attempt >= self._warmup_retries:
                    self._on_warmup_build_failure(key)
                    raise
                attempt += 1
                with self._lock:
                    self.stats.warmup_retries += 1
                time.sleep(self._warmup_backoff_s * (2 ** (attempt - 1)))
            except BaseException:
                # interrupts are never retried; the hook still fires now
                self._on_warmup_build_failure(key)
                raise
        with self._lock:     # success: count the finished warm-up
            self.stats.warmups += 1
            self.stats.compiles += 1
        return built

    def _record_warmup_failure(self, exc: Exception, key: tuple | None = None):
        with self._lock:
            self.stats.warmup_failures += 1
            self._warmup_errors.append(exc)

    def _claim_pending(self):
        """Wait for every queued warm-up and put its step in the cache; a
        failure is recorded (and re-raised by `drain`).  Exactly once per
        future: a future is CLAIMED by popping its key from `_pending`
        under the lock, and only the claimant records its outcome."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                key = next(iter(self._pending))
                fut = self._pending.pop(key)
            try:
                fn = fut.result()
            except Exception as e:               # noqa: BLE001
                self._record_warmup_failure(e, key)
            else:
                with self._lock:
                    self._cache.setdefault(key, fn)

    def drain(self, raise_errors: bool = True):
        """Block until queued warm-ups land in the cache.

        Warm-up exceptions — recorded earlier by `lookup` or surfacing now —
        are re-raised here (the first, with the failure count); with
        raise_errors=False they are only counted in `stats.warmup_failures`."""
        self._claim_pending()
        with self._lock:
            errors, count = list(self._warmup_errors), self.stats.warmup_failures
            self._warmup_errors = []
        if errors and raise_errors:
            raise RuntimeError(
                f"{count} AOT warmup compile(s) failed; first error follows"
            ) from errors[0]


class BucketedEngine(RungCache):
    """Keyed cache of built train steps over a bucket ladder.

    wrap        : the step builder from `make_fsdp_norm_step` /
                  `make_accum_norm_step` (batch_like -> step).
    ladder      : tuple[BatchPlan] from `core.schedule.bucket_ladder`.
    aot_warmup  : build the next rung on the warm-up worker ahead of use.
    coordinator : a `coordination.Coordinator` (None = uncoordinated,
                  bit-identical to the single-host engine): rung-entry
                  barriers, warm-up agreement, failure broadcast.
    persistent_cache_dir : the kernels' libraries are built into and loaded
                  from this directory; `stats.disk_cache_hits` counts the
                  loads since the engine was made.
    """

    def __init__(self, wrap, ladder: tuple[BatchPlan, ...], *,
                 aot_warmup: bool = False, coordinator=None,
                 persistent_cache_dir: str | None = None,
                 warmup_retries: int = 2, warmup_backoff_s: float = 0.05):
        if not ladder:
            raise ValueError("bucket ladder must have at least one rung")
        super().__init__(aot=aot_warmup, warmup_retries=warmup_retries,
                         warmup_backoff_s=warmup_backoff_s)
        self._wrap = wrap
        # the builder's one FlatLayout (None on the tree path): every rung
        # must reuse it, or flat-resident state would not feed the next
        self._flat_layout = getattr(wrap, "flat_layout", None)
        self.ladder = tuple(sorted(ladder, key=lambda p: p.global_batch))
        self._coord = coordinator
        self._last_key = None         # last step signature (transitions)
        self._agree_seq = 0           # monotone warm-up agreement topic id
        self._agreed_for = None       # (bucket, proposal) of the last agreement
        self._agreed_target = None    # ...and the rung the fleet settled on
        if persistent_cache_dir:
            enable_persistent_cache(persistent_cache_dir)
        self._disk_base = disk_cache_hits()

    # ------------------------------------------------------ quantization --

    def bucket_for(self, desired_global: int,
                   max_global: int | None = None) -> BatchPlan:
        return quantize_to_ladder(desired_global, self.ladder, max_global)

    def next_bucket(self, bucket: BatchPlan) -> BatchPlan | None:
        """The next-larger rung (the warm-up target), or None at the top."""
        for plan in self.ladder:
            if plan.global_batch > bucket.global_batch:
                return plan
        return None

    # ------------------------------------------------------------- cache --

    def _build(self, batch_like):
        fn = self._wrap(batch_like)
        if getattr(self._wrap, "flat_layout", None) is not self._flat_layout:
            raise RuntimeError(
                "step builder changed its FlatLayout across bucket "
                "signatures — the layout must be built once and reused for "
                "every ladder rung (DESIGN §9/§10)")
        return fn

    def _aot_build(self, batch_like):
        return self._build(batch_like)

    def check_on_ladder(self, batch_like):
        """Reject a batch whose leading (M, B) dims match no ladder rung,
        before anything is keyed or built."""
        rungs = sorted({(p.accum_steps, p.workers * p.micro_batch)
                        for p in self.ladder})
        for name in sorted(batch_like):
            v = batch_like[name]
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
        """The built step for this (padded) batch's signature; built at most
        once per signature across the run.  Off-ladder shapes raise
        `LadderShapeError`.  With a coordinator, a change of signature is
        a rung transition: remote warm-up failures are polled and the
        rung-entry barrier holds this host until the fleet is there."""
        self.check_on_ladder(batch)
        key = _batch_key(batch)
        if key != self._last_key:
            if self._last_key is not None:
                # a transition: count whether warm-up covered it (built, or
                # pending: waiting on the worker is the warmed path)
                with self._lock:
                    self.stats.transitions += 1
                    if key in self._cache or key in self._pending:
                        self.stats.transition_hits += 1
            if self._coord is not None:
                self._enter_rung(key)
            self._last_key = key
        return self.lookup(key, _spec(batch))

    def _enter_rung(self, key: tuple):
        """Coherent-downgrade check and entry barrier, once per change of
        step signature (DESIGN §8.1)."""
        tag = _key_tag(key)
        if tag in self._coord.poll_failures():
            # some host's warm-up of THIS rung died: a queued-not-started
            # warm-up is cancelled (foreground build instead); a running
            # one is left, since waiting on it IS the synchronous path
            with self._lock:
                fut = self._pending.get(key)
                if fut is not None and fut.cancel():
                    self._pending.pop(key, None)
                    self.stats.coord_downgrades += 1
        wait = self._coord.barrier(f"rung-{tag}")
        with self._lock:
            self.stats.barriers += 1
            self.stats.barrier_wait_s += wait

    def _record_warmup_failure(self, exc: Exception, key: tuple | None = None):
        super()._record_warmup_failure(exc, key)
        if self._coord is not None and key is not None:
            self._coord.broadcast_failure(_key_tag(key))

    def observe(self, plan: BatchPlan, bucket: BatchPlan):
        """Record one executed step's padding accounting."""
        self.stats.steps += 1
        self.stats.real_samples += plan.global_batch
        self.stats.padded_samples += bucket.global_batch - plan.global_batch
        tag = f"{bucket.micro_batch}x{bucket.accum_steps}"
        if tag not in self.stats.buckets_used:
            self.stats.buckets_used.append(tag)
        self._refresh_disk_hits()

    def _refresh_disk_hits(self):
        """Fold the process's persistent-cache loads into the stats (the
        kernels load lazily, at a step's first launch)."""
        hits = disk_cache_hits() - self._disk_base
        if hits > self.stats.disk_cache_hits:
            self.stats.disk_cache_hits = hits

    # ------------------------------------------------------- AOT warm-up --

    def warmup(self, bucket: BatchPlan, batch_example: dict):
        """Queue a warm-up build of `bucket` shaped like `batch_example`
        (tail dims kept, leading dims the rung's (M, B)).  No-op unless
        aot_warmup is on."""
        if not self._aot or bucket is None:
            return
        batch_like = {
            k: ShapeSpec((bucket.accum_steps, bucket.workers * bucket.micro_batch)
                         + tuple(v.shape[2:]), v.dtype)
            for k, v in batch_example.items()}
        self.submit_warmup(_batch_key(batch_like), batch_like)

    def warmup_agreed(self, bucket: BatchPlan, batch_example: dict,
                      proposal: BatchPlan | None = None):
        """Coordinated warm-up: the fleet agrees on ONE rung to build ahead.

        `proposal` is the rung to warm (the caller's target, or None: the
        next-larger rung).  Every host proposes; the leader's wins.  A host
        whose proposal differs counts a `desync` and warms the agreed rung
        anyway.  One agreement per (bucket, proposal) CHANGE, not per step;
        topic ids are a per-engine monotone counter, so every host consumes
        the same topic stream.  Uncoordinated (or world-of-one) engines
        skip the agreement.  Returns the rung queued (None at the top)."""
        if proposal is None:
            proposal = self.next_bucket(bucket)
        if (not self._aot or self._coord is None
                or getattr(self._coord, "world", 1) == 1):
            self.warmup(proposal, batch_example)
            return proposal
        cur = (_plan_tag(bucket), _plan_tag(proposal))
        if cur != self._agreed_for:
            self._agree_seq += 1
            prop_tag = _plan_tag(proposal)
            agreed = self._coord.agree(f"warmup-{self._agree_seq}", prop_tag)
            target = proposal
            if agreed != prop_tag:
                with self._lock:
                    self.stats.desyncs += 1
                target = next(
                    (p for p in self.ladder if _plan_tag(p) == agreed), None)
            self._agreed_for, self._agreed_target = cur, target
        if self._agreed_target is not None:
            self.warmup(self._agreed_target, batch_example)
        return self._agreed_target

    def _on_warmup_build_failure(self, key: tuple):
        # broadcast at once, so hosts polling at rung entry downgrade
        # instead of counting on a warm-up that already died; the local
        # stats stay consumption-time, exactly once
        if self._coord is not None:
            self._coord.broadcast_failure(_key_tag(key))

    def drain(self, raise_errors: bool = True):
        try:
            super().drain(raise_errors)
        finally:
            self._refresh_disk_hits()


__all__ = ["BucketedEngine", "EngineStats", "LadderShapeError", "RungCache",
           "ShapeSpec"]
