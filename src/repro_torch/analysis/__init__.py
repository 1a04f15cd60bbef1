"""repro_torch.analysis — the port's static invariant checker, cost-model
budget gate, and determinism/perf lint (counterpart of `repro/analysis`,
DESIGN §13, §15).

Three layers, none of which computes anything on a device:

* **graph layer** (`graph_check`, `invariants`): trace every step variant
  in the stats × params residency matrix once under fake tensors and
  assert the step-graph invariants: exact pack / unflatten / adjoint
  marker counts, state updated in place where the step means it, bucket
  shards of the sizes `sharding.flat_buffer_specs` gives, no host exits
  in the step, and off-ladder batch shapes rejected before anything is
  built.
* **cost layer** (`costmodel`, `divergence`): per-variant collective
  volume (counts and bytes per kind, attributed to flat bucket groups),
  FLOPs, a storage-liveness watermark and the in-place count, diffed
  against the committed `budget.json` with per-metric tolerances; plus
  the SPMD-divergence lint (collective order stable across two traces
  and equal on two ranks).
* **lint layer** (`lint`): the reference's AST rules over the port's
  source and its timing driver, with the same inline
  ``# repro: allow(<rule>) — <reason>`` waivers.

CLI: ``python -m repro_torch.analysis [--strict] [--json]
[--update-budget] [--device cpu|cuda]`` runs all three and emits a
machine-readable report.
"""

from repro_torch.analysis.costmodel import (
    BUDGET_PATH, DEFAULT_TOLERANCES, CollectiveSite, budget_diff,
    collective_profile, collective_sites, load_budget, measure_variants,
    run_cost_checks, variant_cost, write_budget)
from repro_torch.analysis.divergence import (
    check_fn_divergence, collective_signature, run_divergence_checks)
from repro_torch.analysis.findings import Finding, active, render_report, report_dict
from repro_torch.analysis.graph_check import (
    count_layout_ops, find_host_ops, inplace_effective, iter_ops, trace)
from repro_torch.analysis.invariants import (
    EXPECTED_INPLACE, EXPECTED_LAYOUT_COUNTS, LayoutCounts, build_variants,
    check_ladder_rejection, check_variant, run_invariant_checks)
from repro_torch.analysis.lint import lint_file, register_rule, rules, run_lint

__all__ = [
    "BUDGET_PATH", "CollectiveSite", "DEFAULT_TOLERANCES", "EXPECTED_INPLACE",
    "EXPECTED_LAYOUT_COUNTS", "Finding", "LayoutCounts", "active",
    "budget_diff", "build_variants", "check_fn_divergence",
    "check_ladder_rejection", "check_variant", "collective_profile",
    "collective_signature", "collective_sites", "count_layout_ops",
    "find_host_ops", "inplace_effective", "iter_ops", "lint_file",
    "load_budget", "measure_variants", "register_rule", "render_report", "report_dict", "rules",
    "run_cost_checks", "run_divergence_checks", "run_invariant_checks",
    "run_lint", "trace", "variant_cost", "write_budget",
]
