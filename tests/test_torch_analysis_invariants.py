"""The port's step-graph invariant checker (`repro_torch.analysis`): the
14-variant matrix traces clean on the CPU, its layout counts stand beside
the reference's live counts (each difference named with its reason), its
in-place state beside the reference's donation, and each planted defect —
an extra flatten, an out-of-place moment update, a `.item()` in the step,
an off-ladder batch — gives exactly its finding.

Every trace runs under fake tensors in a fake process group of two; the
matrix is traced once for the module."""

import json
import pathlib

import pytest
import torch

from repro_torch.analysis import (
    EXPECTED_INPLACE, EXPECTED_LAYOUT_COUNTS, check_ladder_rejection,
    check_variant, count_layout_ops, find_host_ops, inplace_effective,
    run_invariant_checks, trace)
from repro_torch.analysis.invariants import (
    BuiltStep, LayoutCounts, StepVariant, _train_builder, build_variants,
    trace_variant)
from repro_torch.distributed.flatbuf import FlatLayout

REPO = pathlib.Path(__file__).parent.parent

# The entries whose count differs from the reference's by structure, and
# why (ROADMAP §3 "Parity notes").  A difference not named here fails.
VIEWS_FOR_ADJOINT = ("the port has no custom-VJP pair: its gradient is born "
                     "flat through ONE unflatten of the gradient buffers, "
                     "which stands in for the adjoint pack")
LAYOUT_DIFFERS = {
    "fsdp_norm/flat/flat": VIEWS_FOR_ADJOINT,
    "accum_norm/flat/flat": VIEWS_FOR_ADJOINT,
    "fsdp_norm_m1/flat/flat": VIEWS_FOR_ADJOINT,
    "accum_norm_m1/flat/flat": VIEWS_FOR_ADJOINT,
    "local_sgd/flat/flat": VIEWS_FOR_ADJOINT + " (once a round)",
    "accum_norm/tree/flat": VIEWS_FOR_ADJOINT,
    "fsdp_norm/tree/flat": VIEWS_FOR_ADJOINT + "; the tree oracle reads the "
                           "params' views, with no handoff of its own, and "
                           "one g serves the statistic and AdamW",
}


@pytest.fixture(scope="module")
def matrix():
    variants = build_variants()
    findings, checked = run_invariant_checks(variants=variants, device="cpu")
    return variants, findings, checked


@pytest.fixture(scope="module")
def reference_counts():
    """The reference's live layout counts of its own 14 variants."""
    from repro.analysis.invariants import _smoke_parts, build_variants as ref_build
    from repro.analysis.jaxpr_check import count_layout_ops as ref_count
    from repro.analysis.jaxpr_check import trace as ref_trace
    from repro.compat import set_mesh
    _, _, mesh = _smoke_parts()
    out = {}
    for v in ref_build():
        with set_mesh(mesh):
            got = ref_count(ref_trace(v.fn, *v.args))
        out[v.name] = LayoutCounts(len(got["pack"]), len(got["unflatten"]),
                                   len(got["adjoint"]))
    return out


def test_matrix_is_clean_on_cpu(matrix):
    """All 14 variants trace with zero invariant findings, and the ladder
    rejection holds."""
    variants, findings, checked = matrix
    active = [f for f in findings if not f.waived]
    assert not active, "\n".join(f.render() for f in active)
    assert len(checked["variants"]) == 14 == len(EXPECTED_LAYOUT_COUNTS)
    assert set(checked["invariants"]) == {
        "pack-count", "inplace", "sharding", "host-callback", "ladder-reject"}
    for v in variants:
        built, st = v.traces[("cpu", 0)]
        assert st.host_exit is None and not find_host_ops(st), v.name
        assert st.flops > 0, v.name


def test_layout_counts_against_reference_live(matrix, reference_counts):
    """Each frozen port count equals the reference's live count of the same
    variant, or is named in `LAYOUT_DIFFERS`; the named ones really do
    differ, and the port's trace equals its frozen entry."""
    variants, _, checked = matrix
    assert sorted(reference_counts) == sorted(v.name for v in variants)
    for v in variants:
        got = checked["layout_counts"][v.name]
        assert LayoutCounts(got["pack"], got["unflatten"], got["adjoint"]) \
            == v.expected, v.name
        ref = reference_counts[v.name]
        if v.name in LAYOUT_DIFFERS:
            assert v.expected != ref, v.name
            # every port difference is the adjoint's stand-in: one more
            # unflatten where the reference binds one adjoint, no adjoint
            assert v.expected.adjoints == 0 and ref.adjoints == 1, v.name
        else:
            assert v.expected == ref, (v.name, v.expected, ref)


def _ref_state_leaves():
    """The reference's state structure: param leaves, flat buckets, and
    the decode cache's leaves (its smoke model's, at its CPU layout)."""
    import jax
    from repro.analysis.invariants import _smoke_parts
    from repro.distributed.flatbuf import FlatLayout as RefLayout
    _, model, _ = _smoke_parts()
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.init_cache(4, 32))
    return (len(jax.tree.leaves(like)), RefLayout.from_tree(like).num_buffers,
            len(jax.tree.leaves(cache)))


def test_inplace_against_reference_donation(matrix):
    """The reference donates every state leaf and XLA aliases them all:
    its committed `donated_aliased` is its whole state's leaf count.  The
    port's in-place count is the leaves of the groups it updates in place
    (`EXPECTED_INPLACE`); every other group — tree-resident state, the
    step count, the local round's averages — comes back in new storage."""
    variants, _, _ = matrix
    budget = json.loads((REPO / "analysis_budget.json").read_text())["variants"]
    leaves, buckets, cache_leaves = _ref_state_leaves()
    for v in variants:
        key = (("serve_decode", "-", "-") if v.name.startswith("serve_decode")
               else tuple(v.name.split("/")))
        step, stats, params = key
        if step == "serve_decode":
            ref_state = cache_leaves
        else:
            opt_flat = (params if step == "local_sgd" else stats) == "flat"
            ref_state = ((buckets if params == "flat" else leaves)
                         + 2 * (buckets if opt_flat else leaves) + 1)
        assert budget[v.name]["donated_aliased"] == ref_state, v.name
        _, st = v.traces[("cpu", 0)]
        groups = EXPECTED_INPLACE.get(key, ())
        member = [p for p in st.inplace
                  if any(p.startswith(g + "[") or p.startswith(g + ".")
                         for g in groups)]
        assert sum(st.inplace.values()) == len(member), v.name
        assert bool(member) == bool(groups), v.name
        assert all(st.inplace[p] for p in member), v.name
        # the step count is never in place: count + 1 is a new tensor
        assert st.inplace.get("opt.count") in (False, None), v.name


# ------------------------------------------------------- planted defects ----

def _planted(build, expected, inplace=()):
    return StepVariant(name="planted", build=build, expected=expected,
                       inplace=inplace)


def _rules(v):
    return [f.rule for f in check_variant(v, device="cpu")]


def test_planted_extra_pack_is_flagged():
    """A step that packs its tree one extra time (the double-pack
    class) is flagged by the pack-count invariant, and only by it; the
    fixed step passes."""
    tree = {"a": torch.zeros(4, device="meta"), "b": torch.zeros(2, 3, device="meta")}
    layout = FlatLayout.from_tree(tree)

    def double_pack(t):
        bufs = layout.flatten(t)
        # the planted defect: a pointless unflatten/flatten round trip
        bufs = layout.flatten(layout.unflatten(list(bufs)))
        return layout.unflatten(list(bufs))

    def single_pack(t):
        return layout.unflatten(list(layout.flatten(t)))

    for fn, rules in ((double_pack, ["pack-count"]), (single_pack, [])):
        v = _planted(lambda device, fn=fn: BuiltStep(fn=fn, args=(tree,), state={}),
                     LayoutCounts(1, 1, 0))
        assert _rules(v) == rules, fn.__name__
    msg = check_variant(_planted(
        lambda device: BuiltStep(fn=double_pack, args=(tree,), state={}),
        LayoutCounts(1, 1, 0)), device="cpu")[0].message
    assert "packs=2" in msg and "packs=1" in msg


def _wrapped(key, wrap_step):
    """The matrix's `key` step, its step function wrapped."""
    inner = _train_builder(*key)

    def build(device):
        built = inner(device)
        built.fn = wrap_step(built.fn, built)
        return built
    return build


def test_planted_extra_flatten_in_a_step_is_flagged():
    """ACCUM-NORM flat/tree with one extra pack of its params: packs 3
    where the catalog says 2 — exactly a pack-count finding."""
    key = ("accum_norm", "flat", "tree")

    def extra(step, built):
        def run(params, *rest):
            built.layout.flatten(params)          # the planted pack
            return step(params, *rest)
        return run

    v = _planted(_wrapped(key, extra), EXPECTED_LAYOUT_COUNTS[key],
                 EXPECTED_INPLACE[key])
    assert _rules(v) == ["pack-count"]


def test_planted_out_of_place_moment_update_is_flagged():
    """A flat step whose first moments come back as copies (the update no
    longer in place) gives exactly an in-place finding, naming them."""
    key = ("accum_norm_m1", "flat", "flat")

    def copy_m(step, built):
        def run(*args):
            params, opt, metrics = step(*args)
            return params, {**opt, "m": tuple(m.clone() for m in opt["m"])}, metrics
        return run

    v = _planted(_wrapped(key, copy_m), EXPECTED_LAYOUT_COUNTS[key],
                 EXPECTED_INPLACE[key])
    findings = check_variant(v, device="cpu")
    assert [f.rule for f in findings] == ["inplace"]
    assert "opt.m[0]" in findings[0].message and "opt.v" not in findings[0].message
    _, st = trace_variant(v, device="cpu")
    _, dead = inplace_effective(st, ("opt.m", "opt.v"))
    assert dead == [p for p in st.inplace if p.startswith("opt.m[")]


def test_planted_item_in_a_step_is_flagged():
    """A step that reads its loss on the host (`.item()`) gives exactly a
    host-callback finding; the trace runs on past the read."""
    key = ("accum_norm_m1", "flat", "flat")

    def item(step, built):
        def run(*args):
            out = step(*args)
            if out[2]["loss"].item() > 1e9:       # the planted sync
                raise AssertionError("unreachable under the stand-in")
            return out
        return run

    v = _planted(_wrapped(key, item), EXPECTED_LAYOUT_COUNTS[key],
                 EXPECTED_INPLACE[key])
    findings = check_variant(v, device="cpu")
    assert [f.rule for f in findings] == ["host-callback"]
    assert "_local_scalar_dense" in findings[0].message


def test_data_dependent_output_is_a_host_exit():
    """An op whose output shape depends on the data cannot run on fake
    tensors: the trace stops there and reports it instead of raising."""
    st = trace(lambda x: torch.nonzero(x > 0), torch.empty(8, device="meta"),
               device="cpu")
    assert st.host_exit == "aten::nonzero"
    assert find_host_ops(st) and "depends on the data" in find_host_ops(st)[0]


def test_off_ladder_batch_rejected_before_any_build():
    """An off-ladder batch raises `LadderShapeError` from `get_step` before
    the builder runs: zero builds, zero compiles, and an error naming the
    leaf and the rungs."""
    from repro_torch.core.schedule import LadderShapeError, parse_ladder
    from repro_torch.distributed.engine import BucketedEngine
    ladder = parse_ladder("2:1,2:2", workers=1)
    builds = []
    engine = BucketedEngine(lambda bl: builds.append(bl), ladder)
    off = {k: torch.empty((3, 2, 16), dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    with pytest.raises(LadderShapeError) as e:
        engine.get_step(off)
    assert "labels" in str(e.value) and "(3, 2)" in str(e.value)
    assert "(1, 2)" in str(e.value)
    assert not builds and engine.stats.compiles == 0
    assert check_ladder_rejection() == []


def test_markers_count_in_order_with_kinds():
    """`flatten`, `unflatten` and `pack_cotangents` each dispatch one marker
    with the layout's leaf count; a gradient's pack is an adjoint."""
    tree = {"w": torch.ones(6, device="meta"), "b": torch.ones(2, device="meta")}
    layout = FlatLayout.from_tree(tree)

    def fn(t):
        bufs = layout.flatten(t)
        views = layout.unflatten(bufs)
        return layout.pack_cotangents(views)

    st = trace(fn, tree, device="cpu")
    assert count_layout_ops(st) == {"pack": [2], "unflatten": [2], "adjoint": [2]}
    assert [r.info[0] for r in st.ops if r.kind == "marker"] == \
        ["pack", "unflatten", "adjoint"]


@pytest.mark.parametrize("entry", ["trace", "trace_variant", "check_variant",
                                   "run_invariant_checks", "run_cost_checks",
                                   "run_divergence_checks"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, every entry point traces the card's route:
    on a torch with no CUDA build it raises before any work rather than
    checking the plain route in its place."""
    from repro_torch.analysis import costmodel, divergence, invariants
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
    v = StepVariant(name="planted/unbuilt", build=lambda device: pytest.fail("built"),
                    expected=LayoutCounts(0, 0, 0))
    calls = {"trace": lambda: trace(lambda: pytest.fail("traced")),
             "trace_variant": lambda: invariants.trace_variant(v),
             "check_variant": lambda: invariants.check_variant(v),
             "run_invariant_checks": lambda: invariants.run_invariant_checks(variants=[v]),
             "run_cost_checks": lambda: costmodel.run_cost_checks(variants=[v]),
             "run_divergence_checks": lambda: divergence.run_divergence_checks([v])}
    with pytest.raises(RuntimeError, match="no CUDA build"):
        calls[entry]()
