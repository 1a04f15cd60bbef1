"""Deterministic fault injection for chaos testing (counterpart of
`repro/testing/faults.py`, DESIGN §12).  It uses no framework, so the port
keeps its own copy: production modules call ``fault_point("site")`` at
their failure-relevant spots, and a configured `FaultInjector` decides,
deterministically by per-site invocation count, whether that call raises,
sleeps, truncates a file, or kills the process.

Sites compiled into the port today:

* ``train.step``            — top of each training-loop iteration (the
                              invocation index IS the 1-based step number);
                              ``die`` here is the kill-at-step-k test.
* ``ckpt.save.before_commit`` — after a checkpoint's temp files are written,
                              before either atomic rename: ``die`` leaves
                              only ``*.tmp*`` litter, which the next save
                              must clean and `latest_step` must never see.
* ``ckpt.saved``            — after a checkpoint commit, with ``path=`` the
                              npz: ``truncate`` produces the torn-file
                              corpus for the loud-restore tests.
* ``engine.compile``        — foreground step build in `RungCache.lookup`.
* ``engine.warmup_compile`` — each ATTEMPT of a warm-up build on the
                              worker (fires again on retry, so ``count``
                              selects transient against permanent failures).
* ``coord.barrier``         — barrier entry in the coordinators (``delay``
                              simulates a straggler, ``die`` a rank lost at
                              the rendezvous).

Configuration is programmatic (``with faults.inject(FaultRule(...)):`` for
in-process tests) or via the ``REPRO_FAULTS`` environment variable — a JSON
rule list parsed at import, which is how tests arm subprocess / CLI
workers:

    REPRO_FAULTS='[{"site": "train.step", "at": 7, "action": "die"}]'

Determinism contract: no wall clock, no RNG — a rule fires iff the site's
invocation counter lands in ``[at, at + count)``, so two runs of the same
deterministic program hit identical faults at identical points.  When no
injector is active, ``fault_point`` is a single attribute load + None check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time

_ACTIONS = ("raise", "delay", "die", "truncate")


class InjectedFault(RuntimeError):
    """Raised by ``action="raise"`` rules at their site."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: fire at invocations [at, at+count) of `site`."""
    site: str
    action: str = "raise"     # raise | delay | die | truncate
    at: int = 1               # first firing invocation (1-based)
    count: int = 1            # how many consecutive invocations fire
    delay_s: float = 0.0      # sleep length for action="delay"
    keep_bytes: int = 0       # truncated size for action="truncate"
    message: str = "injected fault"

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {_ACTIONS})")
        if self.at < 1 or self.count < 1:
            raise ValueError(f"fault window must be at>=1, count>=1: {self}")


class FaultInjector:
    """Deterministic per-site invocation counters driving a rule list.

    Thread-safe: counters update under a lock (warmup-pool threads hit
    engine sites concurrently with the training thread).  `fired` exposes
    the (site, invocation, action) log so tests can assert exactly-once
    firing instead of inferring it from side effects."""

    def __init__(self, rules):
        self.rules = tuple(r if isinstance(r, FaultRule) else FaultRule(**r)
                           for r in rules)
        self._counts: dict[str, int] = {}
        self._log: list[tuple[str, int, str]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, var: str = "REPRO_FAULTS"):
        """An injector from a JSON rule list in the environment (None when
        unset/empty) — how subprocess workers are armed before import."""
        spec = os.environ.get(var, "").strip()
        if not spec:
            return None
        rules = json.loads(spec)
        if isinstance(rules, dict):
            rules = [rules]
        return cls(rules)

    def invocations(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def fired(self, site: str | None = None) -> list[tuple[str, int, str]]:
        with self._lock:
            return [e for e in self._log if site is None or e[0] == site]

    def fire(self, site: str, path: str | None = None, **info) -> None:
        with self._lock:
            n = self._counts[site] = self._counts.get(site, 0) + 1
            hits = [r for r in self.rules
                    if r.site == site and r.at <= n < r.at + r.count]
            for r in hits:
                self._log.append((site, n, r.action))
        for r in hits:      # side effects OUTSIDE the lock
            if r.action == "delay":
                # repro: allow(wallclock-traced) — the delay fault's ACTION is a wall-clock sleep; determinism lives in the rule schedule (site hit counts), not the wait itself
                time.sleep(r.delay_s)
            elif r.action == "die":
                # a real unhandled death (no atexit, no finally blocks) —
                # the same failure mode as a preempted/OOM-killed worker
                # repro: allow(host-divergence) — kills its OWN process; the pid never feeds a traced computation
                os.kill(os.getpid(), signal.SIGKILL)
            elif r.action == "truncate":
                if path is None:
                    raise ValueError(
                        f"truncate rule at site {site!r} needs the site to "
                        "pass path=")
                with open(path, "r+b") as f:
                    f.truncate(r.keep_bytes)
            else:   # "raise"
                raise InjectedFault(f"{site}[{n}]: {r.message}")


# one process-wide active injector; armed from the environment at import so
# CLI/subprocess workers need no code changes to run under faults
_active: FaultInjector | None = FaultInjector.from_env()


def active() -> FaultInjector | None:
    return _active


def fault_point(site: str, **info) -> None:
    """The hook production code calls; near-free when nothing is armed."""
    inj = _active
    if inj is not None:
        inj.fire(site, **info)


@contextlib.contextmanager
def inject(*rules):
    """Arm an injector for the duration of a with-block (in-process tests);
    yields it so the test can assert on `fired()`/`invocations()`."""
    global _active
    prev = _active
    _active = inj = FaultInjector(rules)
    try:
        yield inj
    finally:
        _active = prev


__all__ = ["FaultRule", "FaultInjector", "InjectedFault", "fault_point",
           "inject", "active"]
