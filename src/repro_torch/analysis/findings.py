"""Shared finding/report vocabulary of the analysis layers (counterpart of
`repro/analysis/findings.py`, DESIGN §13).

A `Finding` is one violated invariant or lint rule, locatable (file:line for
the AST lint, step-variant name for the step-graph checker) and machine-readable
(`as_dict` feeds the CLI's JSON report).  Waived lint findings are kept in
the report — a waiver documents a deliberate exception, it doesn't erase
the event — but never fail the gate.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    rule: str                       # e.g. "pack-count", "hash-seed"
    layer: str                      # "graph" | "lint" | "cost"
    location: str                   # "path:line" or a step-variant name
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def as_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        tag = " [waived]" if self.waived else ""
        return f"{self.location}: {self.rule}{tag}: {self.message}"


def active(findings) -> list[Finding]:
    """The findings that fail the gate (waivers excluded)."""
    return [f for f in findings if not f.waived]


def report_dict(findings, *, checked: dict | None = None) -> dict:
    """The machine-readable report: every finding (waived ones flagged),
    plus a `checked` section recording what the run actually covered so a
    clean report is distinguishable from a run that checked nothing."""
    return {
        "findings": [f.as_dict() for f in findings],
        "active": len(active(findings)),
        "waived": sum(1 for f in findings if f.waived),
        "checked": checked or {},
    }


def render_report(findings, *, checked: dict | None = None,
                  as_json: bool = False) -> str:
    if as_json:
        return json.dumps(report_dict(findings, checked=checked), indent=2,
                          sort_keys=True)
    lines = [f.render() for f in findings]
    metrics = ((checked or {}).get("cost") or {}).get("metrics") or {}
    for name in sorted(metrics):
        m = metrics[name]
        comm = sum(e["bytes"] for e in m["collectives"].values())
        nops = sum(e["count"] for e in m["collectives"].values())
        lines.append(
            f"cost {name}: comm={comm}B/{nops}op "
            f"(flatbuf {m['flatbuf']['bytes']}B) flops={m['flops']} "
            f"peak={m['peak_bytes']}B aliased={m['inplace']}")
    act = active(findings)
    lines.append(
        f"{len(act)} finding(s), {len(findings) - len(act)} waived")
    return "\n".join(lines)


__all__ = ["Finding", "active", "report_dict", "render_report"]
