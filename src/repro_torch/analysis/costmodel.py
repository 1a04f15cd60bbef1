"""Layer 3a: the trace-only cost model (counterpart of
`repro/analysis/costmodel.py`, DESIGN §15).

For every step variant in the matrix (`invariants.build_variants`) this
module reads, from one traced step (`graph_check.trace`):

* **collective volume** — op counts and payload bytes per collective kind
  (all-reduce, all-gather, reduce-scatter, all-to-all, collective-permute:
  `launch/roofline.py`'s names), each site attributed to the flat bucket
  groups when an operand is a buffer a layout marker was bound on (marker
  adjacency: the storage is the buffer's), or when its payload is 1-D of a
  bucket's size, whole or a 1/J shard (`collective_sites`).  The step is
  eager, so every collective it makes is dispatched and counted: a
  microbatch loop's all-reduce is seen once a microbatch.
* **FLOPs** — `FlopCounterMode`'s count of the step's products, with the
  `flash_attention` kernel's registered formula, so a CPU trace and a
  trace on fake CUDA tensors count the same products.
* **a peak-memory watermark** — the dry-run tally's storage liveness: the
  largest sum of live storages over the step, inputs included.  A state
  tensor updated in place makes no new storage, so the port's in-place
  updates are credited as the reference credits donation, and a copy in
  their place raises the watermark by the doubled state.
* **the in-place count** — state tensors whose result shares their
  input's storage (`graph_check.inplace_effective`).

All of it is frozen in the port's committed budget
(`src/repro_torch/analysis/budget.json`, traced on the CPU).
`run_cost_checks` diffs a fresh measurement against it — op counts
exactly, bytes, FLOPs and peak within the budget's own tolerances — and
emits findings on any drift in EITHER direction, plus staleness findings
when the budget and the traced matrix disagree about which variants
exist.  On the card the same file gates the exact metrics (op counts,
collective bytes, FLOPs, in-place count); the peak there is the card's
route, so it is printed, not gated.  Intentional changes go through
``python -m repro_torch.analysis --update-budget``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

BUDGET_SCHEMA = 1
BUDGET_FILENAME = "budget.json"
BUDGET_PATH = Path(__file__).resolve().parent / BUDGET_FILENAME

# drift allowed per derived metric before the gate fires; op counts are
# always exact.  The committed file's own `tolerances` block is what the
# diff uses.
DEFAULT_TOLERANCES = {
    "collective_bytes": 0.0,   # payload bytes are pure static-shape math
    "flops": 0.01,
    "peak_bytes": 0.10,        # storage liveness can shift across torch minors
}


@dataclass(frozen=True)
class CollectiveSite:
    """One collective the step dispatched (an eager step dispatches each
    site every time it runs, so there is no trip count to fold in)."""
    kind: str           # `roofline` kind: all-reduce, all-gather, ...
    op: str             # the c10d op
    bytes: int          # payload (result) bytes
    ranks: tuple        # the group's global ranks
    flatbuf: bool       # attributed to a flat bucket group


def _bucket_sizes(layout) -> set:
    sizes = set()
    if layout is not None:
        div = layout.shard_divisor or 1
        for n in layout.buffer_sizes:
            sizes.add(int(n))
            if div > 1 and n % div == 0:
                sizes.add(int(n) // div)
    return sizes


def collective_sites(st, layout=None) -> list[CollectiveSite]:
    """Every collective of a `StepTrace`, in order, each flat-bucket
    attributed when it is marker-adjacent or its payload is 1-D of one of
    `layout`'s bucket sizes (whole or per shard: the params' gather runs
    before any marker is bound on its result)."""
    from repro_torch.analysis.graph_check import iter_ops
    sizes = _bucket_sizes(layout)
    out = []
    for rec in iter_ops(st, "collective"):
        kind, ranks, shapes, nbytes, _, marked = rec.info
        shaped = bool(sizes) and any(len(s) == 1 and s[0] in sizes
                                     for s in shapes)
        out.append(CollectiveSite(kind=kind, op=rec.op, bytes=nbytes,
                                  ranks=ranks, flatbuf=bool(marked or shaped)))
    return out


def collective_profile(st, layout=None) -> dict:
    """The budget's shape: {"per_kind": {kind: {"count", "bytes"}},
    "flatbuf": {"count", "bytes"}} of the flat-bucket-attributed sites."""
    per_kind: dict = {}
    fb_count = fb_bytes = 0
    for s in collective_sites(st, layout):
        e = per_kind.setdefault(s.kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += s.bytes
        if s.flatbuf:
            fb_count += 1
            fb_bytes += s.bytes
    return {"per_kind": dict(sorted(per_kind.items())),
            "flatbuf": {"count": fb_count, "bytes": fb_bytes}}


# -------------------------------------------------------- variant metrics ----

def variant_cost(v, device="cuda") -> dict:
    """All layer-3 metrics for one `StepVariant` (its rank-0 trace on
    `device`, shared with the invariant checks)."""
    from repro_torch.analysis.invariants import trace_variant
    built, st = trace_variant(v, device)
    if st.host_exit is not None:
        raise RuntimeError(f"{v.name}: the trace stopped at a host exit "
                           f"({st.host_exit}); fix the step first")
    prof = collective_profile(st, built.layout)
    return {
        "collectives": prof["per_kind"],
        "flatbuf": prof["flatbuf"],
        "flops": int(st.flops),
        "peak_bytes": st.peak_bytes,
        "inplace": sum(1 for ok in st.inplace.values() if ok),
    }


def measure_variants(variants=None, device="cuda") -> dict:
    """{variant name: metrics} for the whole matrix (or a prebuilt
    subset)."""
    from repro_torch.analysis.invariants import build_variants
    if variants is None:
        variants = build_variants()
    return {v.name: variant_cost(v, device) for v in variants}


# ----------------------------------------------------------------- budget ----

def _topology() -> dict:
    """What the budget's structure depends on: the fake group's size and
    the layout's bucket size (not the device: the card's trace must match
    the CPU's)."""
    from repro_torch.analysis.invariants import BUCKET_BYTES, WORKERS
    return {"workers": WORKERS, "bucket_bytes": BUCKET_BYTES}


def load_budget(path) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_budget(path, measured: dict) -> dict:
    """Freeze `measured` as the committed baseline (atomic replace)."""
    budget = {
        "schema": BUDGET_SCHEMA,
        "topology": _topology(),
        "tolerances": dict(DEFAULT_TOLERANCES),
        "variants": {k: measured[k] for k in sorted(measured)},
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(budget, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return budget


def _rel_drift(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def budget_diff(measured: dict, budget: dict, *, gate_peak: bool = True) -> list:
    """Findings for every way `measured` disagrees with `budget`:
    staleness (variant sets or topology out of sync), exact op-count
    drift, relative metric drift beyond the budget's tolerances, and a
    lost in-place update.  Symmetric — regressions AND improvements both
    require an explicit `--update-budget`.  `gate_peak` False leaves the
    watermark out (the card's trace: its peak is the kernels' route)."""
    from repro_torch.analysis.findings import Finding

    def f(rule, loc, msg):
        return Finding(rule=rule, layer="cost", location=loc, message=msg)

    findings = []
    tol = {**DEFAULT_TOLERANCES, **(budget.get("tolerances") or {})}
    topo = budget.get("topology") or {}
    if topo and topo != _topology():
        findings.append(f(
            "budget-stale", BUDGET_FILENAME,
            f"budget was frozen at topology {topo} but this run traces at "
            f"{_topology()} — collective structure depends on them; "
            f"regenerate with --update-budget"))
        return findings
    b_vars = budget.get("variants") or {}
    for name in sorted(set(measured) - set(b_vars)):
        findings.append(f(
            "budget-stale", name,
            "variant is in the traced matrix but missing from "
            f"{BUDGET_FILENAME}; run --update-budget"))
    for name in sorted(set(b_vars) - set(measured)):
        findings.append(f(
            "budget-stale", name,
            "budget entry matches no variant in the traced matrix "
            "(removed or renamed?); run --update-budget"))
    for name in sorted(set(measured) & set(b_vars)):
        got, want = measured[name], b_vars[name]
        gk, wk = got["collectives"], want.get("collectives", {})
        for kind in sorted(set(gk) | set(wk)):
            g = gk.get(kind, {"count": 0, "bytes": 0})
            w = wk.get(kind, {"count": 0, "bytes": 0})
            if g["count"] != w["count"]:
                findings.append(f(
                    "cost-collectives", name,
                    f"{kind} op count {g['count']} != budget "
                    f"{w['count']} — a collective was added or removed"))
            elif _rel_drift(g["bytes"], w["bytes"]) > tol["collective_bytes"]:
                findings.append(f(
                    "cost-collectives", name,
                    f"{kind} payload {g['bytes']}B drifted from budget "
                    f"{w['bytes']}B (tol {tol['collective_bytes']:.0%})"))
        gf, wf = got["flatbuf"], want.get("flatbuf", {"count": 0, "bytes": 0})
        if gf["count"] != wf["count"]:
            findings.append(f(
                "cost-collectives", name,
                f"flat-bucket-attributed collective count {gf['count']} "
                f"!= budget {wf['count']}"))
        if _rel_drift(got["flops"], want.get("flops", 0)) > tol["flops"]:
            findings.append(f(
                "cost-flops", name,
                f"FLOPs {got['flops']:.4g} drifted from budget "
                f"{want.get('flops', 0):.4g} (tol {tol['flops']:.0%})"))
        if gate_peak and _rel_drift(got["peak_bytes"],
                                    want.get("peak_bytes", 0)) > tol["peak_bytes"]:
            findings.append(f(
                "cost-peak-memory", name,
                f"peak-memory watermark {got['peak_bytes']}B drifted from "
                f"budget {want.get('peak_bytes', 0)}B (tol "
                f"{tol['peak_bytes']:.0%}) — check in-place updates and "
                f"buffer lifetimes"))
        if got["inplace"] < want.get("inplace", got["inplace"]):
            findings.append(f(
                "cost-peak-memory", name,
                f"{got['inplace']} state tensors updated in place vs budget "
                f"{want['inplace']} — an in-place update became a copy"))
    return findings


def run_cost_checks(budget_path=BUDGET_PATH, variants=None, update: bool = False,
                    device="cuda") -> tuple[list, dict]:
    """The layer-3a entry point: measure the matrix on `device`, then diff
    against (or, with `update`, rewrite) the committed budget.  Returns
    (findings, checked) where `checked["metrics"]` carries every variant's
    metrics.  Off the CPU the peak is not gated and `update` is refused:
    the budget is the CPU's trace."""
    from repro_torch.analysis.findings import Finding
    from repro_torch.launch.dryrun import resolve_trace_device
    cpu = str(device) == "cpu"
    if update and not cpu:
        raise ValueError("the budget is frozen from the CPU trace; update it "
                         "with --device cpu")
    device = resolve_trace_device(device)
    measured = measure_variants(variants, device)
    checked = {"budget": str(budget_path), "device": str(device),
               "metrics": measured}
    if update:
        write_budget(budget_path, measured)
        checked["budget_updated"] = True
        return [], checked
    budget = load_budget(budget_path)
    if budget is None:
        return [Finding(
            rule="budget-stale", layer="cost", location=str(budget_path),
            message="no committed cost budget; run `python -m "
                    "repro_torch.analysis --device cpu --update-budget` and "
                    f"commit {BUDGET_FILENAME}")], checked
    return budget_diff(measured, budget, gate_peak=cpu), checked


__all__ = ["BUDGET_FILENAME", "BUDGET_PATH", "CollectiveSite",
           "DEFAULT_TOLERANCES", "budget_diff", "collective_profile",
           "collective_sites", "load_budget", "measure_variants",
           "run_cost_checks", "variant_cost", "write_budget"]
