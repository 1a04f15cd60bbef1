"""A rank's `torch.profiler` trace of the traced steps, its device time put
down to the program's own spans (`repro_torch.tracing`), on the one clock
`time.time_ns` reads.

`reduce_events(events, window, steps, host_spans, program_spans)` is
`trace.reduce_events` with more.  Each device operation is followed to its
runtime launch (the host call that carries its correlation id) and put
down to the innermost program span, on any thread, that holds the
launch's host start:

* `by_span` — device seconds by that span's name (launches inside a
  `step` span);
* `by_phase` — device seconds by the `step.*` span holding the launch
  (`step` for the step's own launches outside them);
* `recompute_s` — device seconds launched inside a `model.*` span that
  lies inside `step.backward`: autograd re-running a checkpointed forward
  (on the card on a thread of its own, so containment is by interval on
  the shared clock, not by the span stack);
* `unattributed_s` — device seconds launched under no `step` span, or
  whose launch is not in the trace;
* `comm` — for each `comm.*` kind, its calls, payload bytes, NCCL bus bytes
  (all-gather and reduce-scatter (n−1)/n × the whole payload, all-reduce
  2(n−1)/n × it) and the NCCL device seconds launched inside it.

The idle gaps are named by the benchmark's own spans first, then by the
innermost program span, then by the runtime call under them.  Without
program spans (None, or none recorded) the result is
`trace.reduce_events`'s alone.
"""

from __future__ import annotations

import numpy as np

from benchkit import trace as trace_lib

BUS_FACTOR = {"comm.all_reduce": lambda n: 2.0 * (n - 1) / n,
              "comm.all_gather": lambda n: (n - 1) / n,
              "comm.reduce_scatter": lambda n: (n - 1) / n}


def reduce_events(events, window: tuple[int, int], steps: int, host_spans=(),
                  program_spans=None) -> dict:
    """`trace.reduce_events(events, window, steps, host_spans)`, and with
    `program_spans` (`repro_torch.tracing.Span`s of the traced steps) the
    device time by span (module docstring)."""
    if not program_spans:
        return trace_lib.reduce_events(events, window, steps, host_spans)
    events = list(events)
    # the benchmark's spans lie between the program's steps, never inside
    # one: as "own" spans both name the gaps they cover, the innermost first
    named = list(host_spans) + [(s.name, s.start_ns, s.end_ns) for s in program_spans]
    out = trace_lib.reduce_events(events, window, steps, named)
    out.update(attribute(events, window, program_spans))
    return out


def _paint(t: np.ndarray, spans, keep) -> np.ndarray:
    """For each sorted launch time of `t`, the index in `spans` of the
    shortest span among those `keep` selects that holds it (-1: none)."""
    owner = np.full(len(t), -1, dtype=np.int64)
    picked = [i for i, s in enumerate(spans) if keep(s.name)]
    for i in sorted(picked, key=lambda i: spans[i].start_ns - spans[i].end_ns):
        lo = np.searchsorted(t, spans[i].start_ns, side="left")
        hi = np.searchsorted(t, spans[i].end_ns, side="right")
        owner[lo:hi] = i
    return owner


def attribute(events, window: tuple[int, int], program_spans) -> dict:
    """The device time of `events` inside `window` by program span."""
    from torch.autograd import DeviceType

    w0, w1 = window
    spans = list(program_spans)
    launch: dict[int, int] = {}        # correlation id -> the launch's host start
    dev = []                           # (name, seconds, correlation id)
    for e in events:
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            if s + d > w0 and s < w1:
                dev.append((e.name(), (min(s + d, w1) - max(s, w0)) * 1e-9,
                            e.correlation_id()))
        elif e.correlation_id():
            launch.setdefault(e.correlation_id(), e.start_ns())
    t = np.asarray([launch.get(c, -1) for _, _, c in dev], dtype=np.int64)
    secs = np.asarray([x for _, x, _ in dev], dtype=np.float64)
    nccl = np.asarray(["nccl" in n.lower() for n, _, _ in dev], dtype=bool)
    order = np.argsort(t, kind="stable")
    t, secs, nccl = t[order], secs[order], nccl[order]
    found = t >= 0

    inner = _paint(t, spans, lambda n: True)
    in_step = (_paint(t, spans, lambda n: n == "step") >= 0) & found
    phase = _paint(t, spans, lambda n: n.startswith("step."))
    in_model = _paint(t, spans, lambda n: n.startswith("model.")) >= 0
    comm = _paint(t, spans, lambda n: n.startswith("comm."))

    by_span: dict[str, float] = {}
    by_phase: dict[str, float] = {}
    recompute = 0.0
    for k in np.nonzero(in_step)[0]:
        name = spans[inner[k]].name
        by_span[name] = by_span.get(name, 0.0) + secs[k]
        p = spans[phase[k]].name if phase[k] >= 0 else "step"
        by_phase[p] = by_phase.get(p, 0.0) + secs[k]
        if in_model[k] and p == "step.backward":
            recompute += secs[k]
    kinds: dict[str, dict] = {}
    for s in spans:
        if s.name.startswith("comm."):
            c = kinds.setdefault(s.name, {"calls": 0, "bytes": 0, "bus_bytes": 0.0,
                                          "nccl_s": 0.0})
            n = int(s.counts.get("group", 1))
            c["calls"] += 1
            c["bytes"] += int(s.counts.get("bytes", 0))
            c["bus_bytes"] += BUS_FACTOR[s.name](n) * s.counts.get("bytes", 0)
    for k in np.nonzero(nccl & (comm >= 0) & found)[0]:
        kinds[spans[comm[k]].name]["nccl_s"] += secs[k]
    return {"by_span": by_span, "by_phase": by_phase, "recompute_s": recompute,
            "unattributed_s": float(secs[~in_step].sum()), "comm": kinds}


def worst_ms(run, seconds) -> float | None:
    """The largest over the ranks' traces of `seconds(trace)` a traced step
    (ms); None without a trace that carries program spans and device
    work."""
    traces = [t for t in run["traces"] if t and "by_phase" in t and t["busy_s"] > 0]
    if not traces:
        return None
    return max(1e3 * seconds(t) / t["steps"] for t in traces)
