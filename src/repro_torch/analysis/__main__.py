"""CLI for the port's static analysis gate: ``python -m repro_torch.analysis``
(counterpart of `python -m repro.analysis`).

Runs all three layers — the AST determinism/perf lint, the trace-only
step-matrix invariant check, and the cost-model + SPMD-divergence layer
(collective volume / FLOPs / storage watermark / in-place count diffed
against the committed `src/repro_torch/analysis/budget.json`) — and
prints a report.  ``--strict`` exits 1 on any unwaived finding, ``--json``
emits the machine-readable report (the per-variant cost metrics ride in
``checked.cost``), and ``--update-budget`` refreezes the budget after an
intentional cost change (from the CPU's trace only).

The steps are traced on the card's route (fake CUDA tensors, the kernels'
custom ops) unless ``--device cpu`` asks for the CPU's (the kernels'
plain versions); a torch with no CUDA build raises without it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="step-graph invariant checker + cost-model budget gate "
                    "+ determinism/perf lint over the port")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unwaived finding (the CI gate)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable JSON report")
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: auto from this file)")
    ap.add_argument("--skip-lint", action="store_true",
                    help="skip the AST lint sweep")
    ap.add_argument("--skip-graph", action="store_true",
                    help="skip the traced layers (invariants AND cost model)")
    ap.add_argument("--skip-cost", action="store_true",
                    help="skip layer 3 (cost model + divergence) only")
    ap.add_argument("--budget", default=None,
                    help="cost-budget baseline path (default: "
                         "src/repro_torch/analysis/budget.json)")
    ap.add_argument("--update-budget", action="store_true",
                    help="refreeze the budget from this run's measurements "
                         "instead of diffing (the intentional-change flow; "
                         "--device cpu; commit the result)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="trace on fake CUDA tensors (the card's route; "
                         "needs a torch with CUDA) or on the CPU")
    args = ap.parse_args(argv)

    from repro_torch.analysis.findings import active, render_report
    from repro_torch.analysis.lint import lint_paths, run_lint

    root = pathlib.Path(args.root) if args.root else \
        pathlib.Path(__file__).resolve().parents[3]
    findings, checked = [], {}
    if not args.skip_graph:
        # refuse a device this torch cannot trace on before any work
        from repro_torch.launch.dryrun import resolve_trace_device
        device = resolve_trace_device(args.device)
    if not args.skip_lint:
        findings.extend(run_lint(root))
        checked["lint_root"] = str(root)
        checked["lint_files"] = len(lint_paths(root))
    if not args.skip_graph:
        from repro_torch.analysis.invariants import (
            build_variants, run_invariant_checks)
        from repro_torch.kernels.ops import flat_dispatch_info
        variants = build_variants()
        gx, gx_checked = run_invariant_checks(variants=variants, device=device)
        findings.extend(gx)
        checked.update(gx_checked)
        checked["dispatch"] = flat_dispatch_info(device)
        if not args.skip_cost:
            from repro_torch.analysis.costmodel import BUDGET_PATH, run_cost_checks
            from repro_torch.analysis.divergence import run_divergence_checks
            budget = pathlib.Path(args.budget) if args.budget else BUDGET_PATH
            cost, cost_checked = run_cost_checks(
                budget, variants=variants, update=args.update_budget,
                device=device)
            findings.extend(cost)
            checked["cost"] = cost_checked
            div, div_checked = run_divergence_checks(variants, device=device)
            findings.extend(div)
            checked["divergence"] = div_checked

    print(render_report(findings, checked=checked, as_json=args.json))
    return 1 if (args.strict and active(findings)) else 0


if __name__ == "__main__":
    sys.exit(main())
