"""The port's cost layer (`repro_torch.analysis.costmodel`, `divergence`):
its collective payloads and FLOPs against the reference's, measured live
on both; planted regressions (an extra all-gather, a rank-dependent and a
host-state-dependent collective order) each give exactly their finding;
the budget's lifecycle (update, round trip, drift and staleness both
ways); and the committed `budget.json` against the traced matrix."""

import itertools
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import (
    BUDGET_PATH, DEFAULT_TOLERANCES, EXPECTED_LAYOUT_COUNTS, budget_diff,
    build_variants, check_fn_divergence, collective_signature, collective_sites,
    load_budget, measure_variants, run_cost_checks, variant_cost, write_budget)
from repro_torch.analysis.costmodel import _topology
from repro_torch.analysis.invariants import (
    WORKERS, BuiltStep, LayoutCounts, StepVariant, _train_builder, trace_variant)

SCALAR_BYTES = 16          # a collective of a few scalars, not a gradient


@pytest.fixture(scope="module")
def matrix():
    variants = build_variants()
    return {v.name: v for v in variants}, measure_variants(variants, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's live profile of its matrix: per variant, its psum
    sites' bytes and its `dot_general` FLOPs with scan trip counts."""
    from repro.analysis.costmodel import _dot_flops, _eqn_subs, _unwrap
    from repro.analysis.costmodel import collective_sites as ref_sites
    from repro.analysis.invariants import _smoke_parts, build_variants as ref_build
    from repro.analysis.jaxpr_check import trace as ref_trace
    from repro.compat import set_mesh

    def dot_flops(jaxpr):
        total = 0
        for eqn in _unwrap(jaxpr).eqns:
            subs, mult, is_cond = _eqn_subs(eqn)
            if subs:
                inner = [dot_flops(s) for s in subs]
                total += max(inner) if is_cond else mult * sum(inner)
            elif eqn.primitive.name == "dot_general":
                total += _dot_flops(eqn)
        return total

    _, _, mesh = _smoke_parts()
    out = {}
    for v in ref_build():
        with set_mesh(mesh):
            t = ref_trace(v.fn, *v.args)
        out[v.name] = {"psum": [s.bytes for s in ref_sites(t) if s.kind == "psum"],
                       "dot_flops": dot_flops(t)}
    return out


def _workers(name):
    """The ranks the port's trace splits the global batch over: the fake
    data group for FSDP-Norm and local-SGD, one rank for the rest (the
    reference traces every variant on one device)."""
    return WORKERS if name.startswith(("fsdp_norm", "local_sgd")) else 1


def _port_all_reduces(v):
    _, st = trace_variant(v, device="cpu")
    return [s.bytes for s in collective_sites(st) if s.kind == "all-reduce"]


@pytest.mark.parametrize("name", ["fsdp_norm/tree/tree", "fsdp_norm/tree/flat",
                                  "fsdp_norm/flat/tree", "fsdp_norm/flat/flat",
                                  "fsdp_norm_m1/flat/flat"])
def test_fsdp_gradient_all_reduce_equals_reference(matrix, reference, name):
    """FSDP-Norm's all-reduce of g_j carries the reference's psum payload
    of the flat gradient, 1 444 352 bytes on smoke llama3.2-1b (its 361 088
    f32 parameters), and with the scalars the same total."""
    variants, measured = matrix
    port = _port_all_reduces(variants[name])
    ref = reference[name]["psum"]
    grad = sum(b for b in port if b > SCALAR_BYTES)
    assert grad == sum(b for b in ref if b > SCALAR_BYTES) == 1444352
    assert sum(port) == sum(ref) == measured[name]["collectives"]["all-reduce"]["bytes"]


@pytest.mark.parametrize("name", ["local_sgd/tree/tree", "local_sgd/flat/tree",
                                  "local_sgd/flat/flat"])
def test_local_sgd_all_reduces_equal_reference(matrix, reference, name):
    """A local-SGD round averages Δ, the params and both moments: four
    gradient-sized payloads, as the reference's psums."""
    variants, _ = matrix
    port = _port_all_reduces(variants[name])
    ref = reference[name]["psum"]
    grad = sum(b for b in port if b > SCALAR_BYTES)
    assert grad == sum(b for b in ref if b > SCALAR_BYTES) == 4 * 1444352
    assert sum(port) == sum(ref)


@pytest.mark.parametrize("name", sorted("/".join(k) if k[0] != "serve_decode"
                                        else "serve_decode/rung2"
                                        for k in EXPECTED_LAYOUT_COUNTS))
def test_flops_equal_reference_dot_flops(matrix, reference, name):
    """The port's FLOPs (its products, `FlopCounterMode`) summed over the
    ranks the batch is split over equal the reference's `dot_general`
    FLOPs with scan trip counts, exactly."""
    _, measured = matrix
    assert measured[name]["flops"] * _workers(name) == reference[name]["dot_flops"]


def _budget():
    return load_budget(BUDGET_PATH)


def test_committed_budget_matches_matrix(matrix):
    """`src/repro_torch/analysis/budget.json` names exactly the traced
    matrix's variants, at this topology, and this run's measurement diffs
    clean against it."""
    _, measured = matrix
    budget = _budget()
    assert budget is not None and budget["schema"] == 1
    assert budget["topology"] == _topology()
    assert sorted(budget["variants"]) == sorted(measured)
    for m in budget["variants"].values():
        assert set(m) == {"collectives", "flatbuf", "flops", "peak_bytes",
                          "inplace"}
    assert budget_diff(measured, budget) == []


# ------------------------------------------------- planted regressions ----

def _wrapped(key, wrap_step):
    inner = _train_builder(*key)

    def build(device):
        built = inner(device)
        built.fn = wrap_step(built.fn)
        return built
    return build


def test_planted_extra_allgather_flagged():
    """FSDP-Norm flat/flat with one extra all-gather (of its loss): the
    budget diff gives exactly a collective-count finding, naming it."""
    key = ("fsdp_norm", "flat", "flat")

    def extra(step):
        def run(*args):
            params, opt, metrics = step(*args)
            parts = [torch.empty_like(metrics["loss"]) for _ in range(WORKERS)]
            dist.all_gather(parts, metrics["loss"])        # the planted one
            return params, opt, metrics
        return run

    v = StepVariant(name="fsdp_norm/flat/flat", build=_wrapped(key, extra),
                    expected=EXPECTED_LAYOUT_COUNTS[key])
    findings = budget_diff({v.name: variant_cost(v, device="cpu")},
                           {**_budget(), "variants": {
                               v.name: _budget()["variants"][v.name]}})
    assert [f.rule for f in findings] == ["cost-collectives"]
    assert "all-gather op count 13 != budget 12" in findings[0].message


def _ordered(flip):
    """A toy step issuing two all-reduces of different sizes, in an order
    `flip()` decides."""
    def build(device):
        def step(a, b):
            first, second = (b, a) if flip() else (a, b)
            dist.all_reduce(first)
            dist.all_reduce(second)
            return a + 1, b + 1
        meta = lambda n: torch.empty(n, device="meta")
        return BuiltStep(fn=step, args=(meta(2), meta(3)), state={})
    return StepVariant(name="planted", build=build,
                       expected=LayoutCounts(0, 0, 0))


def test_planted_rank_dependent_order_flagged():
    """Rank 1 issuing the two collectives in the other order: exactly a
    divergence-rank finding; the same step in a fixed order is clean."""
    v = _ordered(lambda: dist.get_rank() == 1)
    findings = check_fn_divergence(v, device="cpu")
    assert [f.rule for f in findings] == ["divergence-rank"]
    assert "deadlock" in findings[0].message
    assert check_fn_divergence(_ordered(lambda: False), device="cpu") == []


def test_planted_host_state_order_flagged():
    """An order that flips from one trace to the next (host state, not
    rank): exactly a divergence-order finding."""
    calls = itertools.count()
    v = _ordered(lambda: next(calls) == 1)
    assert [f.rule for f in check_fn_divergence(v, device="cpu")] == ["divergence-order"]


def test_collective_signature_orders_and_scopes():
    """The signature is the ordered (kind, ranks, shapes, scope) of each
    collective."""
    _, st = trace_variant(_ordered(lambda: False), device="cpu")
    sig = collective_signature(st)
    assert [(k, r, s) for k, r, s, _ in sig] == [
        ("all-reduce", (0, 1), ((2,),)), ("all-reduce", (0, 1), ((3,),))]


def test_matrix_divergence_clean_on_two_variants(matrix):
    """The shipped steps issue one collective order on two traces and on
    both ranks (FSDP-Norm flat/flat and the flat local-SGD round)."""
    variants, _ = matrix
    for name in ("fsdp_norm/flat/flat", "local_sgd/flat/flat"):
        assert check_fn_divergence(variants[name], device="cpu") == [], name


# ----------------------------------------------------- budget lifecycle ----

def _toy_variant():
    def build(device):
        def step(x, w):
            y = x @ w
            dist.all_reduce(y)
            return (y,)
        meta = lambda *s: torch.empty(*s, device="meta")
        return BuiltStep(fn=step, args=(meta(4, 8), meta(8, 8)), state={})
    return StepVariant(name="planted/clean", build=build,
                       expected=LayoutCounts(0, 0, 0))


def test_budget_roundtrip_update_and_drift(tmp_path):
    """measure -> update -> clean diff; then each perturbation class
    (FLOPs both ways, collective count, peak, in-place) fires its own
    rule."""
    v = _toy_variant()
    path = tmp_path / "budget.json"
    findings, checked = run_cost_checks(path, variants=[v], device="cpu")
    assert [f.rule for f in findings] == ["budget-stale"]
    assert "planted/clean" in checked["metrics"]

    findings, checked = run_cost_checks(path, variants=[v], update=True, device="cpu")
    assert findings == [] and checked["budget_updated"]
    budget = load_budget(path)
    assert budget["topology"] == _topology()
    assert budget["variants"]["planted/clean"]["flops"] == 2 * 4 * 8 * 8
    assert budget["variants"]["planted/clean"]["collectives"] == {
        "all-reduce": {"count": 1, "bytes": 4 * 8 * 4}}
    assert run_cost_checks(path, variants=[v], device="cpu")[0] == []

    for mutate, rule in (
            (lambda e: e.update(flops=e["flops"] * 2), "cost-flops"),
            (lambda e: e.update(flops=e["flops"] // 2), "cost-flops"),
            (lambda e: e["collectives"]["all-reduce"].update(count=2),
             "cost-collectives"),
            (lambda e: e["collectives"]["all-reduce"].update(bytes=1),
             "cost-collectives"),
            (lambda e: e.update(peak_bytes=e["peak_bytes"] * 2),
             "cost-peak-memory"),
            (lambda e: e.update(inplace=e["inplace"] + 1), "cost-peak-memory")):
        b = json.loads(path.read_text())
        mutate(b["variants"]["planted/clean"])
        (tmp_path / "mut.json").write_text(json.dumps(b))
        findings, _ = run_cost_checks(tmp_path / "mut.json", variants=[v], device="cpu")
        assert [f.rule for f in findings] == [rule], (rule, findings)


def test_card_gate_leaves_peak_out():
    """The card's gate (`gate_peak=False`) holds the exact metrics and not
    the watermark; `update` from a non-CPU trace is refused."""
    m = {"collectives": {}, "flatbuf": {"count": 0, "bytes": 0}, "flops": 10,
         "peak_bytes": 100, "inplace": 0}
    budget = {"schema": 1, "tolerances": DEFAULT_TOLERANCES,
              "topology": _topology(), "variants": {"v": dict(m)}}
    moved = {"v": {**m, "peak_bytes": 1000}}
    assert [f.rule for f in budget_diff(moved, budget)] == ["cost-peak-memory"]
    assert budget_diff(moved, budget, gate_peak=False) == []
    with pytest.raises(ValueError):
        run_cost_checks("unused.json", variants=[], update=True, device="cuda")


def test_budget_staleness_both_directions():
    """Variant-set drift between budget and matrix is a finding either way,
    and a topology mismatch short-circuits everything else."""
    m = {"collectives": {}, "flatbuf": {"count": 0, "bytes": 0}, "flops": 1,
         "peak_bytes": 1, "inplace": 0}
    budget = {"schema": 1, "tolerances": DEFAULT_TOLERANCES,
              "topology": _topology(), "variants": {"only/in/budget": dict(m)}}
    findings = budget_diff({"only/in/matrix": dict(m)}, budget)
    assert {f.rule for f in findings} == {"budget-stale"}
    assert {f.location for f in findings} == {"only/in/budget", "only/in/matrix"}

    stale = {**budget, "topology": {**_topology(), "workers": WORKERS + 2}}
    findings = budget_diff({"only/in/matrix": dict(m)}, stale)
    assert len(findings) == 1 and "topology" in findings[0].message


def test_write_budget_is_sorted_and_atomic(tmp_path):
    path = tmp_path / "b.json"
    write_budget(path, {"b": {"x": 1}, "a": {"x": 2}})
    assert list(json.loads(path.read_text())["variants"]) == ["a", "b"]
    assert not (tmp_path / "b.json.tmp").exists()


def test_cli_update_budget_flow(tmp_path, monkeypatch, capsys):
    """`python -m repro_torch.analysis --device cpu --update-budget` freezes
    the budget, a `--strict` run then passes and reports every metric in
    its JSON, and a budget that disagrees fails `--strict` (the matrix
    stood in for by the toy variant)."""
    import repro_torch.analysis.invariants as inv
    from repro_torch.analysis import __main__ as cli
    monkeypatch.setattr(inv, "build_variants", lambda combos=None: [_toy_variant()])
    path = tmp_path / "budget.json"
    base = ["--device", "cpu", "--skip-lint", "--budget", str(path)]
    assert cli.main(base + ["--update-budget"]) == 0
    assert list(load_budget(path)["variants"]) == ["planted/clean"]
    capsys.readouterr()
    assert cli.main(base + ["--strict", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["active"] == 0 and report["checked"]["variants"] == ["planted/clean"]
    assert report["checked"]["dispatch"]["flat_tail"] == "torch-reference"
    assert set(report["checked"]["cost"]["metrics"]["planted/clean"]) == {
        "collectives", "flatbuf", "flops", "peak_bytes", "inplace"}
    b = json.loads(path.read_text())
    b["variants"]["planted/clean"]["flops"] += 1000
    path.write_text(json.dumps(b))
    assert cli.main(base + ["--strict"]) == 1
    assert "cost-flops" in capsys.readouterr().out
