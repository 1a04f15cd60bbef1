"""Layer 3b: the SPMD-divergence lint (counterpart of
`repro/analysis/divergence.py`, DESIGN §15).

Ranks deadlock (or silently desync) when they disagree about which
collective comes next.  Rank-dependent *values* are what collectives are
for; rank-dependent collective ORDER is always a bug.  This module pins
the dynamically checkable half of that contract on the port's eager step:

* **emission-order determinism** — trace every step variant TWICE in one
  process, independently (the step rebuilt for each trace), and require
  equal ordered collective signatures: (kind, group ranks, payload
  shapes, scope), the scope being the port function that issued it.  A
  builder that iterates an unordered container, or reads host state
  (wall clock, pid), emits different sequences on two traces.
* **rank agreement** — trace it once more as rank 1 of the fake data group
  and require rank 0's signature.  A step that branches on its rank
  issues a different sequence there.

The reference's third check, that both branches of a traced `cond` hold
the same collectives, has no eager analog: an eager step takes one branch
and the other is never seen.  A branch on a DEVICE value is a host exit
instead — under fake tensors the value has no data, and
`graph_check.find_host_ops` reports the read — while a branch on a HOST
value that differs by rank is what the rank-agreement trace sees.  The
lexical half lives in `lint.py` (`host-divergence`): host-identity reads
(rank, pid, hostname) inside traced-scope source files.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding


def collective_signature(st) -> tuple:
    """Ordered tuple of the collectives a `StepTrace` dispatched:
    `(kind, group ranks, payload shapes, scope)` each, in emission order."""
    from repro_torch.analysis.graph_check import iter_ops
    return tuple((kind, ranks, shapes, scope) for kind, ranks, shapes, _, scope, _
                 in (rec.info for rec in iter_ops(st, "collective")))


def _first_difference(s1, s2) -> int:
    return next((i for i, (a, b) in enumerate(zip(s1, s2)) if a != b),
                min(len(s1), len(s2)))


def check_fn_divergence(v, location: str | None = None,
                        device="cuda") -> list[Finding]:
    """Both divergence checks on one `StepVariant`: its rank-0 trace (the
    one the other layers read, made here if absent), a fresh rank-0 trace
    and a rank-1 trace, their collective signatures compared."""
    from repro_torch.analysis.invariants import trace_variant
    location = location or v.name
    s0 = collective_signature(trace_variant(v, device)[1])
    again = collective_signature(trace_variant(v, device, fresh=True)[1])
    other = collective_signature(trace_variant(v, device, rank=1, fresh=True)[1])
    findings = []
    if s0 != again:
        findings.append(Finding(
            rule="divergence-order", layer="cost", location=location,
            message=f"two traces of the same step emit different collective "
                    f"sequences (lengths {len(s0)} vs {len(again)}, first "
                    f"divergence at site {_first_difference(s0, again)}) — "
                    f"the builder's emission order is host-state-dependent, "
                    f"so ranks would build different programs and deadlock"))
    if s0 != other:
        findings.append(Finding(
            rule="divergence-rank", layer="cost", location=location,
            message=f"rank 0 and rank 1 emit different collective sequences "
                    f"(lengths {len(s0)} vs {len(other)}, first divergence at "
                    f"site {_first_difference(s0, other)}) — ranks would "
                    f"disagree on the next collective and deadlock"))
    return findings


def run_divergence_checks(variants=None, device="cuda") -> tuple[list[Finding], dict]:
    """Layer 3b over the whole step matrix (or a prebuilt subset)."""
    from repro_torch.analysis.invariants import build_variants
    from repro_torch.launch.dryrun import resolve_trace_device
    device = resolve_trace_device(device)
    if variants is None:
        variants = build_variants()
    findings = []
    for v in variants:
        findings.extend(check_fn_divergence(v, v.name, device))
    checked = {"variants": [v.name for v in variants], "device": str(device),
               "checks": ["divergence-order", "divergence-rank"]}
    return findings, checked


__all__ = ["check_fn_divergence", "collective_signature",
           "run_divergence_checks"]
