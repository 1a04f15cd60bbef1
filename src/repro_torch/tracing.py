"""Spans inside the training step: named host intervals on the clock
`time.time_ns` reads, which is the clock `torch.profiler` stamps its
events with, so that a trace of the card can put each device operation
down to the span its launch ran in.

    from repro_torch import tracing
    tracing.enable()
    ...                       # steps
    tracing.disable()
    spans = tracing.collect()

`span(name, **counts)` is a context manager.  Off (the default) it returns
one shared no-op context: it reads no clock, allocates nothing and
dispatches no torch operation.  On, each span records its name, start and
end, the span that holds it on its own thread, the index of the `step`
span open meanwhile (on any thread: on the card autograd runs the backward,
and with it every recompute, on a thread of its own), its thread, and its
counters.  A span never calls `record_function`, a CUDA event or
`synchronize`, so the step dispatches the same operations, and the device
runs the same timeline, with tracing on or off.

The names, which the benchmark's readers depend on:

* `step` — one call of the built step (`distributed/train_step.py`);
  under it, `step.gather_params` (flat params' all-gather),
  `step.forward`, `step.backward` and `step.accumulate` once a microbatch,
  `step.exchange` (the gradient made whole over the workers),
  `step.statistic`, `step.tail` (the AdamW update) and `step.metrics`.
* `model.block` (the function `remat="full"` re-runs), `model.attention`
  and `model.xent` (a checkpointed chunk): inside `step.backward`, by
  interval, each is a recompute.
* `model.mla` — one call of MLA's expanded form (`models/mla.py`), its
  query chunks' `model.attention` inside it.
* `model.moe.route` (router, softmax, top-k or group-limited choice, aux
  loss, the capacity sort), `model.moe.dispatch` (the held experts' slot
  gather), `model.moe.experts` (their batched SwiGLU; counters `rows`, the
  slots run, E held × C × rows of x, and `d_model`, `d_expert`, all known
  on the host), `model.moe.combine` (gates, each token's slots summed),
  `model.moe.shared` (the shared experts) — one MoE layer
  (`models/moe.py`).  Like every `model.*` span, each lies inside
  `step.backward` when a checkpoint re-runs it.
* `comm.all_gather`, `comm.all_reduce`, `comm.reduce_scatter` — one
  collective; counters `bytes` (the whole payload: an all-gather's output,
  a reduce-scatter's input) and `group` (the group's size).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Span:
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None      # the enclosing span on the same thread
    step: int | None        # the index of the `step` span open meanwhile
    thread: int
    counts: dict


OFF = contextlib.nullcontext()


class _Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.ids = itertools.count()
        self.steps = itertools.count()
        self.step: int | None = None
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


class _Open:
    __slots__ = ("rec", "name", "counts", "id", "parent", "step", "start")

    def __init__(self, rec: _Recorder, name: str, counts: dict):
        self.rec, self.name, self.counts = rec, name, counts

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        self.id = next(rec.ids)
        self.parent = stack[-1] if stack else None
        if self.name == "step":
            rec.step = next(rec.steps)
        self.step = rec.step
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec.stack().pop()
        if self.name == "step":
            rec.step = None
        rec.spans.append(Span(self.id, self.name, self.start, end, self.parent,
                              self.step, threading.get_ident(), self.counts))
        return False


_active: _Recorder | None = None
_last: _Recorder | None = None


def span(name: str, **counts):
    """A context recording the span `name` when tracing is on; the shared
    no-op `OFF` when it is off."""
    rec = _active
    if rec is None:
        return OFF
    return _Open(rec, name, counts)


def enable():
    """Record from here, into a record of its own (the last one's spans are
    dropped)."""
    global _active, _last
    _active = _last = _Recorder()


def disable():
    """Stop recording; what was recorded stays for `collect`."""
    global _active
    _active = None


def collect() -> list[Span]:
    """The spans of the last record that ended (spans still open are not
    in it), by start."""
    if _last is None:
        return []
    return sorted(_last.spans, key=lambda s: (s.start_ns, s.id))
