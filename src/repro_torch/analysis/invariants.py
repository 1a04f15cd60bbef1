"""The step-graph invariant catalog and the trace-only matrix checker
(counterpart of `repro/analysis/invariants.py`, DESIGN §13).

`run_invariant_checks()` builds every step variant the port ships — the
stats × params residency matrix over FSDP-Norm, ACCUM-NORM and local-SGD,
the accumulation-free M = 1 steps, and the serving slot-decode step — at
smoke scale, TRACES each once under fake tensors (`graph_check.trace`:
nothing is allocated or computed), and asserts:

* **layout op counts** (`EXPECTED_LAYOUT_COUNTS`): the exact number of
  pack / unflatten / adjoint-pack marker events in the step.  The port's
  step is an eager loop, so a layout call made once a microbatch is seen
  M times where the reference's scan body counts once; the catalog is the
  port's own, each entry beside the reference's.
* **in-place state** (`inplace_effective`): every state tensor the step
  means to update in place (`StepVariant.inplace`) comes back sharing its
  input's storage — the port's form of the reference's donation check.
* **sharding agreement**: the FSDP-Norm and local-SGD variants run as
  rank 0 of a fake data group of two (`launch/mesh.py::init_fake_workers`;
  a group of one dispatches no collective), and each flat bucket group's
  declared specs equal `sharding.flat_buffer_specs`, its traced tensors
  the sizes those specs give (a moment shard is 1/J of its bucket).
* **no host exits** (`find_host_ops`): no `.item()`, no device-to-host
  copy, no data-dependent output in the step.
* **ladder hygiene**: an off-ladder batch is rejected by
  `BucketedEngine.get_step` with `LadderShapeError` before anything is
  built (`stats.compiles == 0`).

The variants share the reference's plan (global 4, micro 2, accum 2) and
its `accum_free_plan` sub-plan, and a flat layout pinned to the CPU's
bucket size, so that a trace on fake CUDA tensors (the card's kernels)
packs and reduces exactly what the CPU's does.

Run it through ``python -m repro_torch.analysis`` or call the functions:
like the CLI, they trace on the card's route unless ``device="cpu"`` is
given, and raise on a torch with no CUDA build.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_check import (
    count_layout_ops, find_host_ops, inplace_effective, trace)
from repro_torch.launch.dryrun import resolve_trace_device

# the fake data group the variants run in, and the layout's bucket size
WORKERS = 2
BUCKET_BYTES = 128 << 10
SEQ_LEN = 16


@dataclass(frozen=True)
class LayoutCounts:
    """Frozen marker-event counts for one step (see the catalog)."""
    packs: int
    unflattens: int
    adjoints: int


# The port's catalog: layout events per (step, stats_impl, params_impl).
# The reference's count stands beside each entry where it differs, with
# the reason; the port binds "adjoint" only in `pack_cotangents`, which no
# step calls: where the reference's custom-VJP pair transposes the
# gradient into buffers, the port's gradient is born flat, written through
# the views of ONE unflatten of its gradient buffers, and that unflatten
# stands in the adjoint's place.
EXPECTED_LAYOUT_COUNTS = {
    # FSDP-Norm, flat stats over tree params: packs g_j, mean g and the
    # params (3), one unflatten of the gathered params back to a tree —
    # as the reference.  (A step that packed g twice would read packs=4.)
    ("fsdp_norm", "flat", "tree"): LayoutCounts(3, 1, 0),
    # ACCUM-NORM, flat stats over tree params: packs the params and the
    # accumulated g (2), one unflatten of the updated buffers — as the
    # reference.
    ("accum_norm", "flat", "tree"): LayoutCounts(2, 1, 0),
    # flat-resident params, no host-level pack.  The reference: (0, 1, 1),
    # its `unflatten_for_grad` pair.  The port: the params' views (1) and
    # the gradient buffers' views (1, standing in for the adjoint).
    ("fsdp_norm", "flat", "flat"): LayoutCounts(0, 2, 0),
    ("accum_norm", "flat", "flat"): LayoutCounts(0, 2, 0),
    # tree-oracle tail over flat-resident params.  The reference: FSDP-Norm
    # (1, 5, 1), ACCUM-NORM (1, 3, 1): the primal view, the oracle's
    # handoffs (the params, g; FSDP-Norm also g_j and g again for the tree
    # statistic) and the adjoint.  The port: the params' views, which the
    # oracle reads directly, and the gradient buffers' views (the adjoint's
    # stand-in); the handoffs g (ACCUM-NORM), g and g_j (FSDP-Norm, one g
    # for both the statistic and AdamW); the ONE pack of the updated tree
    # re-entering residency.
    ("fsdp_norm", "tree", "flat"): LayoutCounts(1, 4, 0),
    ("accum_norm", "tree", "flat"): LayoutCounts(1, 3, 0),
    # pure tree paths never enter the layout.
    ("fsdp_norm", "tree", "tree"): LayoutCounts(0, 0, 0),
    ("accum_norm", "tree", "tree"): LayoutCounts(0, 0, 0),
    # local-SGD rounds: flat stats pack Δ_j and Δ (2) as the reference;
    # the flat-resident round is buffer arithmetic: the reference's pair
    # (0, 1, 1) from its scanned local step, the port's replica views and
    # gradient views (0, 2, 0), made once a round, not once a local step.
    ("local_sgd", "tree", "tree"): LayoutCounts(0, 0, 0),
    ("local_sgd", "flat", "tree"): LayoutCounts(2, 0, 0),
    ("local_sgd", "flat", "flat"): LayoutCounts(0, 2, 0),
    # accumulation-free M = 1 sub-steps: the same builders at leading dims
    # (1, J·mb); the flat/flat pair as above (the reference: (0, 1, 1)).
    ("fsdp_norm_m1", "flat", "flat"): LayoutCounts(0, 2, 0),
    ("accum_norm_m1", "flat", "flat"): LayoutCounts(0, 2, 0),
    # serving decode: the KV cache is resident, nothing enters a layout.
    ("serve_decode", "-", "-"): LayoutCounts(0, 0, 0),
}

# The state groups each variant updates IN PLACE (where the reference
# donates every state buffer and XLA aliases them all).  The port's flat
# tail writes its params and moment buffers in place; tree-resident state
# comes back as new tensors (the tree oracle, leaf by leaf), so does a
# flat buffer re-packed from a tree, the step count (count + 1), and the
# local-SGD round's averaged replica and moments (the workers' means);
# the serving cache is written in place.
EXPECTED_INPLACE = {
    ("fsdp_norm", "flat", "flat"): ("params", "opt.m", "opt.v"),
    ("accum_norm", "flat", "flat"): ("params", "opt.m", "opt.v"),
    ("fsdp_norm_m1", "flat", "flat"): ("params", "opt.m", "opt.v"),
    ("accum_norm_m1", "flat", "flat"): ("params", "opt.m", "opt.v"),
    ("fsdp_norm", "flat", "tree"): ("opt.m", "opt.v"),
    ("accum_norm", "flat", "tree"): ("opt.m", "opt.v"),
    ("serve_decode", "-", "-"): ("cache",),
}


@dataclass
class BuiltStep:
    """One variant's step as built in a fake group: the step, its abstract
    operands (meta tensors become fake ones on the trace device), which
    operands are state and where each comes back, its `FlatLayout` (None
    on tree paths), its flat bucket groups as (label, declared specs,
    required specs), and J, the size of the data group its buckets are
    sharded over."""
    fn: object
    args: tuple
    state: dict
    layout: object = None
    flat_groups: list = field(default_factory=list)
    workers: int = 1


@dataclass
class StepVariant:
    """One traced-step check target (built by `build_variants`).  `build`
    takes the trace device and returns a `BuiltStep`; it is called inside
    a fake group (`fake_group`), once for each trace."""
    name: str
    build: object
    expected: LayoutCounts
    inplace: tuple = ()
    # (device, rank) -> (BuiltStep, StepTrace) of the traces kept
    traces: dict = field(default_factory=dict)


# ------------------------------------------------------- variant builders ----

_SMOKE_CACHE = []


def _smoke_parts():
    """One smoke-scale (config, model) per process, shared by every
    variant."""
    if not _SMOKE_CACHE:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.model import build_model
        cfg = get_smoke_config("llama3.2-1b")
        _SMOKE_CACHE.append((cfg, build_model(cfg)))
    return _SMOKE_CACHE[0]


@contextlib.contextmanager
def fake_group(rank: int = 0):
    """Join a fake process group of `WORKERS` ranks as `rank` for the span
    (every collective moves nothing); it is left on exit.  Refuses to run
    inside another process group."""
    from repro_torch.launch.mesh import init_fake_workers
    if dist.is_initialized():
        raise RuntimeError("the analysis traces inside its own fake process "
                           "group; leave the current one first")
    init_fake_workers(WORKERS, rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(x):
    return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")


def _batch_like(plan):
    import numpy as np
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    cfg, _ = _smoke_parts()
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    return {k: _meta(torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in make_batch(src, 0, plan, SEQ_LEN).items()}


def _train_builder(step_impl: str, stats_impl: str, params_impl: str):
    from repro_torch.core.schedule import BatchPlan, accum_free_plan
    from repro_torch.distributed.local_step import make_local_sgd_step
    from repro_torch.distributed.sharding import flat_buffer_specs
    from repro_torch.distributed.train_step import (
        make_accum_norm_step, make_fsdp_norm_step)
    from repro_torch.launch.mesh import data_axes, make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat

    accum_free = step_impl.endswith("_m1")
    base = step_impl.removesuffix("_m1")
    plan = BatchPlan(global_batch=4, micro_batch=2, accum_steps=2, workers=1)
    if accum_free:
        plan, _ = accum_free_plan(plan)

    def build(device) -> BuiltStep:
        _, model = _smoke_parts()
        like = model.init(device="meta")
        kw = dict(stats_impl=stats_impl, params_impl=params_impl,
                  params_like=like, device=device, bucket_bytes=BUCKET_BYTES)
        mesh, axes, J = None, (), 1
        if base == "fsdp_norm":
            # rank 0 of a data group of two: the buckets sharded over it
            mesh = make_host_mesh(data=WORKERS)
            axes, J = data_axes(mesh), WORKERS
            wrap = make_fsdp_norm_step(model, AdamWConfig(), mesh=mesh, **kw)
        elif base == "accum_norm":
            wrap = make_accum_norm_step(model, AdamWConfig(), **kw)
        else:
            # the round's workers are the group's ranks; replicas whole
            wrap = make_local_sgd_step(model, AdamWConfig(), **kw)
        layout = wrap.flat_layout
        # optimizer residency: the train steps key it on stats_impl, the
        # local round on params_impl (the tree round runs the tree AdamW)
        opt_flat = (params_impl if base == "local_sgd" else stats_impl) == "flat"
        opt = (init_adamw_flat(like, layout=layout, device="meta") if opt_flat
               else init_adamw(like))
        params = (tuple(torch.empty(n // J, dtype=dt, device="meta")
                        for n, dt in zip(layout.buffer_sizes, layout.buffer_dtypes))
                  if params_impl == "flat" else like)
        lr = torch.zeros((), dtype=torch.float32)       # the host's scalar
        flat_groups = []
        if layout is not None:
            required = flat_buffer_specs(layout.num_buffers, axes)
            declared = getattr(wrap, "param_specs", None)
            if declared is None:          # the local round declares none
                declared = required
            if opt_flat:
                flat_groups += [("opt.m", tuple(declared), required),
                                ("opt.v", tuple(declared), required)]
            if params_impl == "flat":
                flat_groups += [("params", tuple(declared), required)]
        return BuiltStep(fn=wrap(None), args=(params, opt, _batch_like(plan), lr),
                         state={"params": (0, 0), "opt": (1, 1)}, layout=layout,
                         flat_groups=flat_groups, workers=J)

    return build


def _serve_builder():
    from repro_torch.distributed.serve_step import make_slot_decode_step

    def build(device) -> BuiltStep:
        _, model = _smoke_parts()
        like = model.init(device="meta")
        step = make_slot_decode_step(model, max_slots=4)(2)
        cache = model.init_cache(4, 32, device="meta")
        tok = torch.empty(2, dtype=torch.int32, device="meta")
        return BuiltStep(fn=step, args=(like, cache, tok, tok),
                         state={"cache": (1, 1)})

    return build


def build_variants(combos=None) -> list[StepVariant]:
    """Every step variant in the matrix, at smoke scale (built lazily, in
    a fake group, at each trace).  `combos` optionally restricts to a
    subset of `EXPECTED_LAYOUT_COUNTS` keys."""
    wanted = set(combos) if combos is not None else None
    keys = [(s, st, p) for s in ("fsdp_norm", "accum_norm")
            for st in ("tree", "flat") for p in ("tree", "flat")]
    keys += [("fsdp_norm_m1", "flat", "flat"), ("accum_norm_m1", "flat", "flat")]
    keys += [("local_sgd", st, p) for st, p in
             (("tree", "tree"), ("flat", "tree"), ("flat", "flat"))]
    variants = []
    for key in keys:
        if wanted is None or key in wanted:
            variants.append(StepVariant(
                name="/".join(key), build=_train_builder(*key),
                expected=EXPECTED_LAYOUT_COUNTS[key],
                inplace=EXPECTED_INPLACE.get(key, ())))
    key = ("serve_decode", "-", "-")
    if wanted is None or key in wanted:
        variants.append(StepVariant(
            name="serve_decode/rung2", build=_serve_builder(),
            expected=EXPECTED_LAYOUT_COUNTS[key],
            inplace=EXPECTED_INPLACE[key]))
    return variants


def trace_variant(v: StepVariant, device="cuda", rank: int = 0,
                  fresh: bool = False):
    """(BuiltStep, StepTrace) of `v` traced on `device` as `rank` of the
    fake group; rank 0's is kept on the variant and reused unless `fresh`."""
    device = resolve_trace_device(device)
    key = (str(device), rank)
    if not fresh and key in v.traces:
        return v.traces[key]
    with fake_group(rank):
        built = v.build(device)
        st = trace(built.fn, *built.args, device=device, state=built.state)
    if not fresh:
        v.traces[key] = (built, st)
    return built, st


# --------------------------------------------------------------- checking ----

def check_variant(v: StepVariant, device="cuda") -> list[Finding]:
    """All invariant findings for one step variant (trace-only)."""
    findings = []

    def bad(rule, msg):
        findings.append(Finding(rule=rule, layer="graph", location=v.name,
                                message=msg))

    built, st = trace_variant(v, device)
    got = count_layout_ops(st)
    counts = LayoutCounts(packs=len(got["pack"]),
                          unflattens=len(got["unflatten"]),
                          adjoints=len(got["adjoint"]))
    if counts != v.expected:
        bad("pack-count",
            f"layout op counts {counts} != expected {v.expected} "
            f"(pack leaf counts: {got['pack']})")

    host = find_host_ops(st)
    if host:
        bad("host-callback",
            f"host-exiting ops in the step: {sorted(set(host))}")

    if st.host_exit is None:
        _, dead = inplace_effective(st, v.inplace)
        if dead:
            bad("inplace",
                f"state {dead} came back in new storage (of "
                f"{len(st.inplace)} state tensors) — the in-place update "
                f"silently became a copy and the state is double-allocated")

    layout = built.layout
    for label, declared, required in built.flat_groups:
        if tuple(declared) != tuple(required):
            bad("sharding",
                f"{label} bucket specs {declared} != flat_buffer_specs "
                f"{required}")
        if st.host_exit is not None:
            continue
        # the group's traced bucket sizes against its specs': whole where
        # a spec names no axis, else 1/J (the data axes shard a bucket)
        sizes = [math.prod(shape) for path, shape in st.shapes.items()
                 if path.startswith(label + "[")]
        want = [n // built.workers if spec else n
                for n, spec in zip(layout.buffer_sizes, required)]
        if sizes != want:
            bad("sharding",
                f"{label} traced bucket sizes {sizes} != the sizes "
                f"flat_buffer_specs gives {want}")
    return findings


def check_ladder_rejection() -> list[Finding]:
    """An off-ladder batch must raise `LadderShapeError` from
    `BucketedEngine.get_step` BEFORE anything is built: zero builds, zero
    cache entries."""
    from repro_torch.core.schedule import LadderShapeError, parse_ladder
    from repro_torch.distributed.engine import BucketedEngine
    findings = []
    ladder = parse_ladder("2:1,2:2", workers=1)
    calls = []
    engine = BucketedEngine(lambda bl: calls.append(bl), ladder)
    off = {k: torch.empty((3, 2, SEQ_LEN), dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    try:
        engine.get_step(off)
    except LadderShapeError:
        pass
    else:
        findings.append(Finding(
            rule="ladder-reject", layer="graph", location="engine.get_step",
            message="off-ladder batch (M=3) was NOT rejected"))
    if calls or engine.stats.compiles:
        findings.append(Finding(
            rule="ladder-reject", layer="graph", location="engine.get_step",
            message=f"off-ladder batch reached the build path "
                    f"({len(calls)} builds, {engine.stats.compiles} "
                    f"compiles) — rejection must cost zero builds"))
    return findings


def run_invariant_checks(combos=None, variants=None,
                         device="cuda") -> tuple[list[Finding], dict]:
    """The full trace-only matrix check on `device`.  Returns (findings,
    checked), `checked` recording coverage and each variant's layout
    counts for the report.  Pass prebuilt `variants` to share their
    traces with the cost and divergence layers (the CLI does)."""
    device = resolve_trace_device(device)
    if variants is None:
        variants = build_variants(combos)
    findings, layout = [], {}
    for v in variants:
        findings.extend(check_variant(v, device))
        got = count_layout_ops(v.traces[(str(torch.device(device)), 0)][1])
        layout[v.name] = {k: len(x) for k, x in got.items()}
    findings.extend(check_ladder_rejection())
    checked = {
        "device": str(device),
        "variants": [v.name for v in variants],
        "layout_counts": layout,
        "invariants": ["pack-count", "inplace", "sharding", "host-callback",
                       "ladder-reject"],
    }
    return findings, checked


__all__ = ["BUCKET_BYTES", "BuiltStep", "EXPECTED_INPLACE",
           "EXPECTED_LAYOUT_COUNTS", "LayoutCounts", "StepVariant", "WORKERS",
           "build_variants", "check_ladder_rejection", "check_variant",
           "fake_group", "run_invariant_checks", "trace_variant"]
