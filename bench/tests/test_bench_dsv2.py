"""DeepSeek-V2 at one expert-parallel rank's share
(`deepseek-v2-236b-l5e20`, cell `dsv2-l5e20.accum.s4096`): the
configuration through the checks every configuration passes, its cell run
at smoke size on the CPU against the plain reference, and the cell's three
readers (`mla_ms`, `moe_dispatch_ms`, `moe_experts_tflops`) on made-up
events."""

import json

import pytest

import bench_setup  # noqa: F401  (the import path)
from benchkit import cli
from benchkit import spans as spans_lib
from benchkit.manifest import (BENCH, ROOT, Cell, _load_module, find, load_manifest,
                               metric_reader)
from benchkit.program import model_dict, traffic_dict
from test_bench_counts import (check_flops_per_token, check_parameter_count,
                               check_shapes_match_the_port)
from test_bench_manifest import check_config_entry, check_published
from test_bench_spans import Ev, _span

M = load_manifest()
CONFIG, CELL = "deepseek-v2-236b-l5e20", "dsv2-l5e20.accum.s4096"
READERS = ("mla_ms", "moe_dispatch_ms", "moe_experts_tflops")
expert_flops_per_step = _load_module(BENCH / "metrics" / "moe_experts_tflops.py",
                                     "metric").expert_flops_per_step


def test_configuration_passes_the_checks():
    entry = find(M["configs"], CONFIG, "config")
    check_config_entry(M, ROOT, entry)
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["reduced"] == ["num_hidden_layers", "n_routed_experts", "vocab_size"]
    check_published(body, entry["reduced"], entry["file"])
    assert body["param_count"] == 3_145_466_880
    check_parameter_count(M, ROOT, CONFIG)
    check_shapes_match_the_port(M, ROOT, CONFIG)
    assert body["flops_per_token"] == {"seq_len": 4096, "value": pytest.approx(12.6128e9,
                                                                              rel=1e-4)}
    check_flops_per_token(M, ROOT, CONFIG)


def test_cell_reports_its_readers_and_the_rate():
    c = Cell(M, CELL)
    assert {m["name"] for m in c.metrics("end_to_end")} == {
        "train_tokens_per_s", "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in c.metrics("per_layer")}
    assert set(READERS) | {"mfu", "device_idle_pct", "fused_adamw_stats_roofline",
                           "host_loop_ms", "forward_ms", "backward_ms", "recompute_ms",
                           "grad_accum_ms"} == layer
    # a phi3 cell reads nothing there
    assert not set(READERS) & {m["name"] for m in Cell(M, "phi3-l8.accum.s2048")
                               .metrics("per_layer")}


def _run(*extra, seed=2**31 + 131, trace=0):
    code, result = cli.run(["--workload", CELL, "--seed", str(seed), "--seconds", "1",
                            "--trace", str(trace), "--device", "cpu", "--smoke", *extra])
    assert code == 0
    return result


def test_port_matches_the_reference_and_records_its_spans():
    from repro_torch import tracing
    r = _run(trace=1)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    spans = tracing.collect()
    names = {s.name for s in spans}
    # (at 32 positions MLA's attention runs whole, with no chunk spans)
    assert {"model.mla", "model.moe.route", "model.moe.dispatch", "model.moe.experts",
            "model.moe.combine", "model.moe.shared"} <= names
    m = Cell(M, CELL).config["smoke"]["moe"]
    # rows: the held experts' slots of the one row a microbatch,
    # C = floor(1.25 · 32 · 3 / 16)
    counts = {(s.counts["rows"], s.counts["d_model"], s.counts["d_expert"])
              for s in spans if s.name == "model.moe.experts"}
    assert counts == {(m["num_experts"] * 7, 64, m["d_expert"])}
    # the reader's count of the products is what the spans ran
    c = Cell(M, CELL)
    steps = sum(s.name == "step" for s in spans)
    ran = sum(6.0 * s.counts["rows"] * s.counts["d_model"] * s.counts["d_expert"]
              for s in spans if s.name == "model.moe.experts")
    assert steps >= 1 and ran == steps * expert_flops_per_step(
        model_dict(c.config, True), traffic_dict(c.traffic, True))


def test_state_left_unchanged_is_not_correct():
    # (the half-batch fault halves each microbatch's rows: at micro 1 it
    # leaves none, so this cell's fault is the state returned unchanged)
    r = _run("--fault", "unchanged")
    assert not r["correct"]
    # the moments stay nought
    assert r["checks"]["moment_leaf_gap"]["value"] == pytest.approx(1.0)


# one step on [0, 3000]: the forward on thread 1, a layer's recompute on
# autograd's thread 2 inside the backward
SPANS = [_span(0, "step", 0, 3000),
         _span(1, "step.forward", 10, 1000, 0),
         _span(2, "model.block", 20, 990, 1),
         _span(3, "model.mla", 30, 400, 2),
         _span(4, "model.attention", 100, 200, 3),
         _span(5, "model.moe.route", 410, 500, 2),
         _span(6, "model.moe.dispatch", 510, 560, 2),
         _span(7, "model.moe.experts", 570, 700, 2, rows=3840, d_model=5120, d_expert=1536),
         _span(8, "model.moe.combine", 710, 800, 2),
         _span(9, "model.moe.shared", 810, 900, 2),
         _span(10, "step.backward", 1010, 2900, 0),
         _span(11, "model.block", 1100, 1600, None, thread=2),
         _span(12, "model.mla", 1110, 1300, 11, thread=2),
         _span(13, "model.moe.experts", 1400, 1500, 11, thread=2, rows=3840, d_model=5120,
               d_expert=1536)]
# (launch at, device op, its interval)
LAUNCHES = [(40, "gemm", 40, 60), (110, "softmax", 60, 100), (420, "sort", 100, 110),
            (520, "gather", 110, 115), (580, "bmm", 115, 215), (720, "gather", 215, 218),
            (820, "gemm", 218, 250), (1120, "gemm", 1120, 1150), (1410, "bmm", 1410, 1510),
            (2000, "gemm", 2000, 2400)]
EV = ([Ev("cudaLaunchKernel", t, t + 5, c, dev=False)
       for c, (t, _, _, _) in enumerate(LAUNCHES, 1)]
      + [Ev(n, s, e, c) for c, (_, n, s, e) in enumerate(LAUNCHES, 1)])


def _view(*traces):
    return {"chips": 1, "trace": True, "traces": list(traces), "peaks": None, "steps": []}


def test_readers():
    t = spans_lib.reduce_events(EV, (0, 3000), 1, [], SPANS)
    # ms a step: MLA 20 + 40 + 30 ns; route, dispatch, combine 10 + 5 + 3
    assert metric_reader("mla_ms")(_view(t)) == pytest.approx(90e-6)
    assert metric_reader("moe_dispatch_ms")(_view(t)) == pytest.approx(18e-6)
    # the cell's products a step: 4 MoE layers × M 4 × forward and
    # recompute of 20 experts × C 192 × 1 row (the spans' counters)
    flops = 4 * 4 * 2 * 6.0 * 3840 * 5120 * 1536
    c = Cell(M, CELL)
    assert expert_flops_per_step(c.config["model"], c.traffic) == flops
    assert metric_reader("moe_experts_tflops")(_view(t)) == pytest.approx(
        flops / 200e-9 / 1e12)
    # the worst rank's time, and the slowest rank's rate
    slow = dict(t, by_span=dict(t["by_span"], **{"model.mla": 70e-9,
                                                  "model.moe.experts": 400e-9}))
    assert metric_reader("mla_ms")(_view(t, slow)) == pytest.approx(110e-6)
    assert metric_reader("moe_experts_tflops")(_view(t, slow)) == pytest.approx(
        flops / 400e-9 / 1e12)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_spans(name):
    # the program as it was before these spans: a layer and its attention
    old = [s for s in SPANS if s.name in ("step", "step.forward", "step.backward",
                                          "model.block", "model.attention")]
    assert metric_reader(name)(_view(None)) is None
    assert metric_reader(name)(_view(spans_lib.reduce_events(EV, (0, 3000), 1, [],
                                                             old))) is None

