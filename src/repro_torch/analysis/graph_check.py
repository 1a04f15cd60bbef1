"""Step-graph primitives of the static invariant checker (counterpart of
`repro/analysis/jaxpr_check.py`, DESIGN §13).

The port has no jaxpr: its step is eager Python.  Here one step is RUN
once under `FakeTensorMode` (shapes, dtypes and devices, no storage and no
arithmetic) inside the dry-run's tracer (`launch/dryrun.py`: `Trace`, its
`TraceTally`), and the ordered record of what it dispatched is kept: every
op, each flat-layout event (`repro_torch::layout_marker`, bound by
`FlatLayout.flatten` / `unflatten` / `pack_cotangents`), each `c10d`
collective with its group and payload, and each exit to the host.  The
tally's FLOPs, storage peak and collective counts come with it.

Where the reference reads donation from the lowered HLO, the port reads
storage: a state tensor (params, moments, count, cache) whose result
shares its input's storage was updated in place (`inplace_effective`).

A host exit cannot run under fake tensors: `.item()`, `bool()` or
`int()` of a device value (`aten._local_scalar_dense`) and an op whose
output shape depends on the data raise there.  The tally records them as
host ops instead of letting them escape: a scalar read is answered with a
stand-in (1, 1.0 or True) so that the step runs on, and a data-dependent
shape ends the trace, which keeps what it saw.  A copy of a device tensor
to the CPU is recorded as a host op and runs.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from weakref import WeakSet

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException, DynamicOutputShapeException, FakeTensorMode)

from repro_torch.launch import roofline
from repro_torch.launch.dryrun import (
    Trace, TraceTally, _fake, _nbytes, _tensors, resolve_trace_device)

LAYOUT_MARKER = "repro_torch::layout_marker"
_SCALAR_READ = "aten::_local_scalar_dense"
_COPIES = ("aten::_to_copy", "aten::copy_")
# frames skipped when naming the scope of a collective: the tracer and the
# collective helpers
_HELPERS = ("launch/mesh.py", "launch/dryrun.py", "analysis/graph_check.py",
            "distributed/sharding.py")
_PACKAGE = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class OpRecord:
    """One dispatched op, in order.  `kind` is "compute", "marker",
    "collective" or "host"; `info` is, for a marker, (event kind, leaf
    count); for a collective, (kind, group ranks, payload shapes, payload
    bytes, scope, whether an operand is a marked layout buffer); for a
    host op, (reason,)."""
    op: str
    kind: str
    info: tuple = ()


class HostExit(RuntimeError):
    """The step needed a device value's data on the host (a fake tensor has
    none)."""


def _scope() -> str:
    """`file:function` of the nearest port frame that called a collective,
    past the collective helpers."""
    frame = sys._getframe(2)
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if path.is_relative_to(_PACKAGE):
            rel = path.relative_to(_PACKAGE).as_posix()
            if rel not in _HELPERS:
                return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


class GraphTally(TraceTally):
    """The dry-run's tally, keeping the ordered op record as well."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        self._marked = WeakSet()

    def _marked_operand(self, tensors) -> bool:
        return any(t.untyped_storage() in self._marked for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name == LAYOUT_MARKER:
            bufs, kind, nleaves = args
            for b in bufs:
                self._marked.add(b.untyped_storage())
            self.ops.append(OpRecord(name, "marker", (kind, int(nleaves))))
        elif func.namespace in roofline.COLLECTIVE_NAMESPACES:
            kind, ranks, results, operands = roofline.collective_parts(func, args)
            res = _tensors(results)
            self.ops.append(OpRecord(name, "collective", (
                kind, tuple(ranks), tuple(tuple(t.shape) for t in res),
                sum(_nbytes(t) for t in res), _scope(),
                self._marked_operand(res + _tensors(operands)))))
        elif name == _SCALAR_READ:
            self.ops.append(OpRecord(name, "host", (
                "a device value read on the host (.item(), bool(), int())",)))
            dtype = args[0].dtype
            return (True if dtype == torch.bool else
                    1.0 if dtype.is_floating_point else 1)
        else:
            self.ops.append(OpRecord(name, "compute"))
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        except (DataDependentOutputException, DynamicOutputShapeException) as e:
            self.ops.append(OpRecord(name, "host", (
                "an output whose shape or value depends on the data",)))
            raise HostExit(name) from e
        if name in _COPIES:
            src = [t for t in _tensors(args) if t.device.type != "cpu"]
            if src and any(t.device.type == "cpu" for t in _tensors(out)):
                self.ops.append(OpRecord(name, "host", (
                    "a device tensor copied to the CPU",)))
        return out


@dataclass
class StepTrace:
    """What one traced step dispatched, and what it cost."""
    ops: list
    flops: float = 0.0
    flops_by_class: dict = field(default_factory=dict)
    peak_bytes: int = 0
    collectives: dict = field(default_factory=dict)
    kernel_calls: dict = field(default_factory=dict)
    # state leaf path -> whether its result shares its input's storage,
    # and the result's shape
    inplace: dict = field(default_factory=dict)
    shapes: dict = field(default_factory=dict)
    host_exit: str | None = None
    seconds: float = 0.0


def _paths(tree, prefix: str):
    """(path, tensor) of every tensor leaf, dict keys sorted."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}[{i}]")


def trace(fn, *args, device="cuda", state=None) -> StepTrace:
    """Run `fn(*args)` once under `FakeTensorMode` and return its
    `StepTrace`.  Tensor leaves of `args` are made fake: a meta leaf on
    `device` (the card's route on "cuda": the kernels are custom ops with
    fake implementations), any other on its own device (a host scalar
    stays on the host).  `state` maps a name to (argument index, result
    index) for the step's state (e.g. {"params": (0, 0), "opt": (1, 1)}):
    each leaf's in-place flag lands in `StepTrace.inplace`.  The device
    is the card's unless "cpu" is asked for; a torch with no CUDA build
    raises on "cuda"."""
    device = resolve_trace_device(device)
    tally = GraphTally()
    st = StepTrace(ops=tally.ops)
    t0 = time.perf_counter()
    tr = Trace(tally)
    try:
        with FakeTensorMode(), tr:
            fake = _fake(args, device)
            out = fn(*fake)
            for name, (a, r) in (state or {}).items():
                ins = list(_paths(fake[a], name))
                outs = dict(_paths(out[r], name))
                st.shapes.update({p: tuple(y.shape) for p, y in outs.items()})
                for path, x in ins:
                    y = outs.get(path)
                    st.inplace[path] = (
                        y is not None and x.untyped_storage()._cdata
                        == y.untyped_storage()._cdata)
            del out, fake
    except HostExit as e:
        st.host_exit = str(e)
    st.seconds = time.perf_counter() - t0
    if st.host_exit is None:
        st.flops = tr.cost["flops"]
        st.flops_by_class = tr.cost["flops_by_class"]
        st.peak_bytes = tally.peak
        st.collectives = tally.collectives
        st.kernel_calls = {k: n for k, n in tr.kernel_calls.items() if n}
    return st


def iter_ops(target, kind: str | None = None):
    """The records of a `StepTrace` (or of a list of records), in order;
    only those of `kind` when given."""
    ops = target.ops if isinstance(target, StepTrace) else target
    for rec in ops:
        if kind is None or rec.kind == kind:
            yield rec


def count_layout_ops(target, *args, **kwargs) -> dict:
    """The flat-layout marker events of a step: {"pack": [...],
    "unflatten": [...], "adjoint": [...]}, one entry per event in dispatch
    order, valued with its leaf count.  `target` is a `StepTrace`, or a
    callable traced at `*args` (`trace`'s keywords pass through)."""
    st = target if isinstance(target, StepTrace) else trace(target, *args, **kwargs)
    out: dict = {"pack": [], "unflatten": [], "adjoint": []}
    for rec in iter_ops(st, "marker"):
        out[rec.info[0]].append(rec.info[1])
    return out


def find_host_ops(st: StepTrace) -> list[str]:
    """`op: reason` of every host exit in the step (the counterpart of
    `find_host_eqns`): a device value read on the host, a device tensor
    copied to the CPU, an output that depends on the data."""
    return [f"{rec.op}: {rec.info[0]}" for rec in iter_ops(st, "host")]


def inplace_effective(st: StepTrace, groups=()) -> tuple[dict, list]:
    """(the in-place flag of every state leaf, the leaves of `groups` whose
    result does NOT share its input's storage).  A group is a state path
    prefix ("params", "opt.m", "cache"); the second list should be empty
    for every group the step means to update in place — a copy there
    doubles that state's memory, the class the reference's
    `donation_effective` guards."""
    def member(path):
        return any(path == g or path.startswith((g + "[", g + "."))
                   for g in groups)
    return st.inplace, [p for p, ok in st.inplace.items()
                        if member(p) and not ok]


__all__ = ["GraphTally", "HostExit", "LAYOUT_MARKER", "OpRecord", "StepTrace",
           "count_layout_ops", "find_host_ops", "inplace_effective",
           "iter_ops", "trace"]
