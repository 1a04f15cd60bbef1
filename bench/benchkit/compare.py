"""The comparison that decides `correct`: the numbers compared between
what the timed path produced in the check steps and what the plain
reference computes from the same seed, each held to its own limit (the
cell's `limits/<cell>.json`, set from measured readings, see PERF.md).

* `loss_gap`, `var_l1_gap`, `grad_sqnorm_gap` — the largest relative gap
  over the check steps of the loss, the norm test's ‖Var‖₁ and ‖g‖².
* `grad_leaf_gap` — the first gradient as the optimizer got it (after
  clipping), by the worst leaf: |‖a‖ − ‖b‖| over the larger of the
  reference's norm of that leaf and of the median leaf.
* `update_leaf_gap` — the same for each leaf's change over the check steps.
* `moment_leaf_gap` — the same for both AdamW moments after them.

The controller's decision of each check step is not compared: it read
alike on every seed, under the control and under every fault (PERF.md
§2), so it has no reading that a limit could separate.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (nought to rounding) are left out of the leaf gaps.
"""

from __future__ import annotations

import math
import statistics


def _rel_gap(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-300) for x, y in zip(a, b))


def _leaf_gap(a: dict, b: dict, keep) -> float:
    ref = [b[p] for p in keep]
    floor = statistics.median(ref) if ref else 0.0
    return max((abs(a[p] - b[p]) / max(b[p], floor, 1e-300) for p in keep),
               default=0.0)


def readings(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad_leaf"].values())
    keep = [p for p, g in ref["grad_leaf"].items() if g >= 1e-3 * med]
    if set(prog["grad_leaf"]) != set(ref["grad_leaf"]):
        raise ValueError("the program's and the reference's leaves differ")
    out = {
        "loss_gap": _rel_gap(prog["loss"], ref["loss"]),
        "var_l1_gap": _rel_gap(prog["var_l1"], ref["var_l1"]),
        "grad_sqnorm_gap": _rel_gap(prog["grad_sqnorm"], ref["grad_sqnorm"]),
        "grad_leaf_gap": _leaf_gap(prog["grad_leaf"], ref["grad_leaf"], keep),
        "update_leaf_gap": _leaf_gap(prog["update_leaf"], ref["update_leaf"], keep),
        "moment_leaf_gap": max(_leaf_gap(prog["m_leaf"], ref["m_leaf"], keep),
                               _leaf_gap(prog["v_leaf"], ref["v_leaf"], keep)),
    }
    # a number that is not finite (a NaN loss, say) fails every limit
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """For each leaf quantity, the leaf that sets its gap (diagnostics)."""
    med = statistics.median(ref["grad_leaf"].values())
    keep = [p for p, g in ref["grad_leaf"].items() if g >= 1e-3 * med]
    out = {}
    for q in ("grad_leaf", "update_leaf", "m_leaf", "v_leaf"):
        floor = statistics.median(ref[q][p] for p in keep)
        gap = {p: abs(prog[q][p] - ref[q][p]) / max(ref[q][p], floor, 1e-300)
               for p in keep}
        p = max(gap, key=gap.get)
        out[q] = [p, gap[p], ref[q][p] / floor]
    out["left_out"] = sorted(set(ref["grad_leaf"]) - set(keep))
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name (a number whose readings no limit separates is not
    compared, PERF.md §2): every one at or under its limit."""
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
