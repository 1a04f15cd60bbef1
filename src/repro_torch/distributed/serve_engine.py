"""Adaptive continuous-batching serve engine (DESIGN §11) — counterpart of
`repro/distributed/serve_engine.py`.

`ServeEngine` quantizes the IN-FLIGHT request batch onto a powers-of-two
rung ladder of decode steps (`serve_step.make_slot_decode_step`), keeps the
built steps in a `RungCache`, and adapts the active rung to measured load
via `core.serve_controller`, as the reference does.

Residency: ONE KV buffer of `max_slots` rows is allocated at construction
and never reallocated.  Requests own slot rows; admission zeroes a row,
completion backfills the freed row from the highest active slot
(`move_slot`), and a rung change re-slices the same buffer.  The slot
operations and the decode write into the buffer in place (the reference
donates it through compiled steps).

Continuous batching at token granularity: every in-flight request lives on
its own timeline (per-slot positions).  A newly admitted request streams
its prompt through the same rung decode step (teacher-forced), then flips
to generation.  Greedy decoding only: the argmax is taken on the device,
and one (b,) int32 vector comes back to the host a step.

A rung's build: on the card the rung's decode step captured as a CUDA
graph over the resident cache (`serve_step.GraphedDecode`, the port's
counterpart of the reference's compiled executable), the rungs sharing
one graph memory pool; on the CPU the eager step.  Warm-up (`warm`, and
the neighbours of the active rung after every step) runs the builds on
the `RungCache` worker thread, and the engine waits for the ones it
queued before its next device work: a capture must not overlap the
engine's own launches, slot copies or the drivers' device
synchronisations, and a run makes only a handful of builds.  The step's
neighbours stay pending until a lookup claims them, as in the reference,
so `compiles`, `warmups` and `transition_hits` count as the reference's
do.

On a mesh (`mesh=`, one process a rank; `launch/serve.py` starts them)
every rank runs the same host logic on the same submits.  The engine keeps
this rank's slices of the params (`param_pspecs(fsdp=False)`) and of the
pool (`cache_pspecs` over `model`); the pool's slots spread over the data
ranks in turn (`serve_step.slot_home`: slot s on data rank s mod J as its
row s div J), so a rung b with J | b touches rows [0, b/J) on every rank
and no row moves, while a rung with b mod J != 0 leaves the later data
ranks a row fewer (or none), and compaction broadcasts a row that changes
rank.  A pool of max_slots that J does not divide is whole on every data
rank, as the reference replicates it.  A step's one host read is the
rank's own next tokens, then one all-gather over the data group (of host
tensors: gloo) gives every rank the rung's tokens in slot order, and the
ranks agree on the step's seconds (their max) before the controller sees
them, so every rank takes the same decision.  The rungs are CUDA graphs on
the card when the model axis is 1 (the all-gather stays outside the
graph); on a model axis above 1 they run eagerly, decided at
construction: gloo's host-staged TP all-reduces cannot be captured, and
NCCL cannot put two ranks on one card.  A capture that fails still raises.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import wait
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.serve_controller import (
    ServeControllerConfig, init_serve_controller, observe_step_latency,
    serve_controller_update, serve_ladder)
from repro_torch.distributed.engine import EngineStats, RungCache
from repro_torch.distributed.serve_step import (
    GraphedDecode, gather_slots, local_cache, make_slot_decode_step, move_slot,
    param_slices, reset_slot, rung_rows)
from repro_torch.launch.mesh import host_max, num_workers, worker_index
from repro_torch.tree import tree_leaves


class QueueFullError(RuntimeError):
    """Admission control: the engine's wait queue is at `max_queue` and this
    request was REJECTED (never enqueued).  Callers load-shed."""

    def __init__(self, message: str, *, queued: int = 0, max_queue: int = 0):
        super().__init__(message)
        self.queued = queued
        self.max_queue = max_queue


@dataclass
class ServeStats(EngineStats):
    """Engine counters plus serving-tier accounting.  `steps` counts engine
    decode iterations; `real_samples`/`padded_samples` count occupied and
    empty slot-rows per step, so `padding_waste` is the fraction of decode
    rows burned on empty slots."""
    requests_submitted: int = 0
    requests_completed: int = 0
    requests_rejected: int = 0    # load-shed at submit (queue at max_queue)
    tokens_generated: int = 0     # generated (post-prompt) tokens only
    prompt_tokens: int = 0        # prompt tokens streamed through decode
    rung_transitions: int = 0     # steps whose rung differs from the last
    transition_hits: int = 0      # ...that found the step already built
    slot_resets: int = 0          # admissions (each zeroes one slot row)
    slot_moves: int = 0           # compaction copies after completions

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update({
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            "rung_transitions": self.rung_transitions,
            "transition_hits": self.transition_hits,
            "slot_resets": self.slot_resets,
            "slot_moves": self.slot_moves,
        })
        return d


@dataclass
class Request:
    """One in-flight generation request (host-side bookkeeping)."""
    rid: int
    prompt: np.ndarray                # (prompt_len,) int32
    max_new_tokens: int
    arrival_s: float
    generated: list = field(default_factory=list)
    pos: int = 0                      # next cache position its slot writes
    n_consumed: int = 0               # prompt tokens streamed so far
    first_token_s: float | None = None
    done_s: float | None = None

    @property
    def prefilling(self) -> bool:
        return self.n_consumed < len(self.prompt)

    @property
    def latency_s(self) -> float | None:
        return None if self.done_s is None else self.done_s - self.arrival_s


class ServeEngine(RungCache):
    """Ladder-bucketed continuous-batching engine over one resident KV pool.

    model / params : the served model (`decode_step` API) and its whole
                     params; the engine runs on the device they lie on.
    mesh           : None (one process), or the (data, model) mesh of this
                     process group: the engine keeps this rank's slices
                     (module docstring).
    max_slots      : top rung — the resident cache's slot-row count.
    cache_len      : per-slot cache length; every request must satisfy
                     prompt_len + max_new_tokens <= cache_len.
    ladder         : ascending request-batch rungs (default: powers of two
                     up to max_slots).
    controller     : `ServeControllerConfig` (default: ladder + eager grow,
                     patience-4 shrink, no latency SLO).
    aot_warmup     : build the steps of the rungs adjacent to the active
                     one ahead of use, so a rung change is a cache hit.
    """

    def __init__(self, model, params, mesh=None, *, max_slots: int,
                 cache_len: int, ladder: tuple[int, ...] | None = None,
                 controller: ServeControllerConfig | None = None,
                 aot_warmup: bool = False, ring: bool = False,
                 max_queue: int = 0):
        if ring:
            raise NotImplementedError(
                "ring-buffer slot caches need per-slot wrap accounting")
        super().__init__(aot=aot_warmup, stats=ServeStats())
        self.ladder = tuple(sorted(set(ladder))) if ladder else \
            serve_ladder(max_slots)
        if self.ladder[-1] > max_slots:
            raise ValueError(
                f"ladder top {self.ladder[-1]} exceeds max_slots {max_slots}")
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.mesh = mesh
        self.device = tree_leaves(params)[0].device
        # the data ranks the slots spread over, and this rank's index
        self._J, self._j = 1, 0
        if mesh is None:
            self._params = params
            self._wrap = make_slot_decode_step(model, max_slots=max_slots)
            self._kv = model.init_cache(max_slots, cache_len, device=self.device)
        else:
            self._wrap, p_specs, cache_specs = make_slot_decode_step(
                model, mesh, max_slots=max_slots)
            self._params = param_slices(params, p_specs, mesh)
            if max_slots % num_workers(mesh) == 0:
                self._J, self._j = num_workers(mesh), worker_index(mesh)
            self._kv_like = model.init_cache(max_slots, cache_len, device="meta")
            self._c_specs = cache_specs(self._kv_like)
            self._kv = local_cache(self._kv_like, self._c_specs, mesh, self.device,
                                   rows=max_slots // self._J)
        self._slot_mesh = mesh if self._J > 1 else None
        self._graphs = self.device.type == "cuda" and (
            mesh is None or mesh.model_size == 1)
        if self._graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)

        self._ctrl_cfg = controller or ServeControllerConfig(ladder=self.ladder)
        if self._ctrl_cfg.ladder != self.ladder:
            raise ValueError("controller ladder must match engine ladder")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue            # 0 = unbounded (the default)
        self.ctrl = init_serve_controller(self._ctrl_cfg)
        self.queue: deque[Request] = deque()
        self._active: list[Request] = []      # index == slot row
        self._last_rung: int | None = None
        self._next_rid = 0

    # --------------------------------------------------------- admission --

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def current_rung(self) -> int:
        return self.ladder[self.ctrl.rung]

    def submit(self, prompt, max_new_tokens: int,
               arrival_s: float | None = None) -> Request:
        """Enqueue one request; decode work happens in `step()`.

        Raises `QueueFullError` (and counts `requests_rejected`) when the
        wait queue already holds `max_queue` requests — malformed requests
        (empty prompt, cache overrun) stay ValueError and count as neither
        submitted nor rejected."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt_len {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds cache_len {self.cache_len}")
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.stats.requests_rejected += 1
            raise QueueFullError(
                f"serve queue full: {len(self.queue)} queued >= max_queue "
                f"{self.max_queue} (request rejected, not enqueued)",
                queued=len(self.queue), max_queue=self.max_queue)
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival_s=time.time() if arrival_s is None else arrival_s)
        self._next_rid += 1
        self.queue.append(req)
        self.stats.requests_submitted += 1
        return req

    def _admit(self, req: Request):
        reset_slot(self._kv, len(self._active), self._slot_mesh)
        self.stats.slot_resets += 1
        req.pos = 0
        req.n_consumed = 0
        self._active.append(req)

    # -------------------------------------------------------- decode step --

    def _rung_key(self, b: int) -> tuple:
        return ("decode", b, self.cache_len)

    def _build(self, b: int):
        step = self._wrap(b) if self.mesh is None else self._wrap(b, self._kv_like)
        rows = rung_rows(b, self._J, self._j)
        if not self._graphs or rows == 0:
            return step
        return GraphedDecode(step, self._params, self._kv, rows,
                             pool=self._graph_pool, stream=self._capture_stream)

    def _aot_build(self, b: int):
        return self._build(b)

    def _settle_warmups(self):
        """Wait for the queued warm-up builds to finish (they stay pending:
        `lookup` and `drain` claim and account them)."""
        with self._lock:
            pending = list(self._pending.values())
        wait(pending)

    def warm(self, rungs) -> None:
        """Build the steps of the given rung batch sizes ahead of use, and
        wait for them to land in the cache (a failure is recorded and
        re-raised by `drain`)."""
        for b in rungs:
            if b in self.ladder:
                self.submit_warmup(self._rung_key(b), b)
        self._claim_pending()

    def _warm_adjacent(self, rung_idx: int):
        """The controller moves one rung at a time: build both neighbours."""
        for j in (rung_idx + 1, rung_idx - 1):
            if 0 <= j < len(self.ladder):
                self.submit_warmup(self._rung_key(self.ladder[j]),
                                   self.ladder[j])

    def step(self) -> dict | None:
        """One engine iteration: controller decision, admissions, one
        decode step at the active rung, host-side advance + completions.
        Returns a step report, or None when idle."""
        if not self._active and not self.queue:
            return None
        self.ctrl = serve_controller_update(
            self._ctrl_cfg, self.ctrl, queued=len(self.queue),
            active=len(self._active))
        rung_idx = self.ctrl.rung
        b = self.ladder[rung_idx]
        while self.queue and len(self._active) < b:
            self._admit(self.queue.popleft())

        key = self._rung_key(b)
        if b != self._last_rung:
            if self._last_rung is not None:
                self.stats.rung_transitions += 1
                if self.cached(key):
                    self.stats.transition_hits += 1
            self._last_rung = b
        fn = self.lookup(key, b)

        tokens = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        for s, r in enumerate(self._active):
            tokens[s] = (r.prompt[r.n_consumed] if r.prefilling
                         else r.generated[-1])
            pos[s] = r.pos
        t0 = time.time()
        mine = slice(self._j, b, self._J)    # this rank's slots of the rung
        tokens, pos = torch.from_numpy(tokens[mine]), torch.from_numpy(pos[mine])
        if not self._graphs:                 # a graph stages them itself
            tokens, pos = tokens.to(self.device), pos.to(self.device)
        out_tok, self._kv = fn(self._params, self._kv, tokens, pos)
        out = self._rung_tokens(out_tok.cpu(), b)   # waits for the device step
        # agreed over the mesh (the slowest rank's), so every rank's
        # controller takes the same decision
        dt = time.time() - t0 if self.mesh is None else host_max(time.time() - t0)
        self.ctrl = observe_step_latency(self._ctrl_cfg, self.ctrl,
                                         rung_idx, dt)
        if self._aot:
            self._warm_adjacent(rung_idx)
            self._settle_warmups()

        completed = self._advance(out)
        self.stats.steps += 1
        self.stats.real_samples += len(self._active) + len(completed)
        self.stats.padded_samples += b - len(self._active) - len(completed)
        tag = str(b)
        if tag not in self.stats.buckets_used:
            self.stats.buckets_used.append(tag)
        return {"rung": b, "active": len(self._active),
                "queued": len(self.queue), "step_s": dt,
                "completed": completed}

    def _rung_tokens(self, mine: torch.Tensor, b: int) -> np.ndarray:
        """The rung's next tokens in slot order from this rank's: one
        all-gather over the data group when the slots spread over it."""
        if self._J == 1:
            return mine.numpy()
        n = -(-b // self._J)
        padded = torch.zeros(n, dtype=torch.int32)
        padded[:len(mine)] = mine
        parts = [torch.empty_like(padded) for _ in range(self._J)]
        dist.all_gather(parts, padded, group=self.mesh.data_group)
        return torch.stack(parts, dim=1).reshape(-1)[:b].numpy()

    def gathered_cache(self) -> list:
        """The resident pool whole, slots in global order, on every rank
        (every rank of the mesh calls it); no mesh: the pool itself."""
        if self.mesh is None:
            return self._kv
        return gather_slots(self._kv, self._c_specs, self.mesh)

    def _advance(self, out: np.ndarray) -> list[Request]:
        """Fold one step's sampled tokens into per-request state; retire
        finished requests and compact their slots (highest active slot
        backfills the freed row — its cache row moves, nothing else)."""
        now = time.time()
        done_slots = []
        for s, r in enumerate(self._active):
            if r.prefilling:
                r.n_consumed += 1
                self.stats.prompt_tokens += 1
                if not r.prefilling:     # last prompt token -> first output
                    r.generated.append(int(out[s]))
                    r.first_token_s = now
                    self.stats.tokens_generated += 1
            else:
                r.generated.append(int(out[s]))
                self.stats.tokens_generated += 1
            r.pos += 1
            if (len(r.generated) >= r.max_new_tokens
                    or r.pos >= self.cache_len):
                r.done_s = now
                done_slots.append(s)
        completed = [self._active[s] for s in done_slots]
        for s in sorted(done_slots, reverse=True):
            last = len(self._active) - 1
            if s != last:
                move_slot(self._kv, last, s, self._slot_mesh)
                self._active[s] = self._active[last]
                self.stats.slot_moves += 1
            self._active.pop()
        self.stats.requests_completed += len(completed)
        return completed

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Step until queue and in-flight batch are empty; returns every
        request completed along the way."""
        done: list[Request] = []
        for _ in range(max_steps):
            report = self.step()
            if report is None:
                return done
            done.extend(report["completed"])
        raise RuntimeError(f"not drained after {max_steps} steps "
                           f"(active={len(self._active)}, "
                           f"queued={len(self.queue)})")


__all__ = ["QueueFullError", "Request", "ServeEngine", "ServeStats"]
