"""Port fault-injection harness (`repro_torch/testing/faults.py`) against the
cases of tests/test_faults.py: rule-window semantics, nesting, validation,
each action (a real SIGKILL for ``die``), arming from ``REPRO_FAULTS``,
and the same fired log as the reference's harness for one rule schedule.
Everything is exact: the harness is control flow, no floats."""

import json
import os
import subprocess
import sys
import time

import pytest

from repro.testing import faults as jfaults
from repro_torch.testing.faults import (
    FaultInjector, FaultRule, InjectedFault, active, fault_point, inject)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def test_rule_window_fires_exact_invocations():
    """A rule fires on invocations [at, at+count) of ITS site and nowhere
    else — the whole determinism contract in one test."""
    with inject(FaultRule(site="x", at=2, count=2)) as inj:
        fault_point("x")                       # 1: before the window
        for n in (2, 3):                       # 2, 3: inside
            with pytest.raises(InjectedFault, match=f"x\\[{n}\\]"):
                fault_point("x")
        fault_point("x")                       # 4: after the window
        fault_point("y")                       # other sites never fire
        assert inj.invocations("x") == 4
        assert inj.invocations("y") == 1
        assert inj.fired("x") == [("x", 2, "raise"), ("x", 3, "raise")]
        assert inj.fired("y") == []


def test_inject_nests_and_restores():
    assert active() is None
    with inject(FaultRule(site="a")) as outer:
        assert active() is outer
        with inject(FaultRule(site="b")) as inner:
            assert active() is inner
            fault_point("a")                   # outer's rule is NOT armed
            with pytest.raises(InjectedFault):
                fault_point("b")
        assert active() is outer
    assert active() is None


def test_rule_validation():
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultRule(site="x", action="explode")
    with pytest.raises(ValueError, match="at>=1"):
        FaultRule(site="x", at=0)


def test_delay_action_sleeps():
    with inject(FaultRule(site="slow", action="delay", delay_s=0.08)):
        t0 = time.monotonic()
        fault_point("slow")
        assert time.monotonic() - t0 >= 0.06


def test_truncate_action_tears_the_file(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"x" * 100)
    with inject(FaultRule(site="tear", action="truncate", keep_bytes=7)):
        fault_point("tear", path=str(p))
    assert p.stat().st_size == 7
    # a truncate rule at a site that passes no path is a loud setup error
    with inject(FaultRule(site="tear", action="truncate")):
        with pytest.raises(ValueError, match="path"):
            fault_point("tear")


def test_from_env_parses_json_list_and_single_dict(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS",
                       '[{"site": "s", "at": 3, "action": "delay"}]')
    inj = FaultInjector.from_env()
    assert inj.rules == (FaultRule(site="s", at=3, action="delay"),)
    monkeypatch.setenv("REPRO_FAULTS", '{"site": "t"}')
    assert FaultInjector.from_env().rules == (FaultRule(site="t"),)
    monkeypatch.setenv("REPRO_FAULTS", "")
    assert FaultInjector.from_env() is None


def test_die_action_sigkills_subprocess():
    """``die`` is a real SIGKILL (no cleanup, no excepthook) — the process
    exits with signal 9 exactly at the scheduled invocation; the process
    imports the port's harness only."""
    code = (
        "import sys\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.testing.faults import fault_point\n"
        "for i in range(10):\n"
        "    print('tick', i + 1, flush=True)\n"
        "    fault_point('train.step')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["REPRO_FAULTS"] = json.dumps(
        [{"site": "train.step", "at": 3, "action": "die"}])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=60)
    assert p.returncode == -9, (p.returncode, p.stderr)
    assert p.stdout.splitlines()[-1] == "tick 3"


def test_same_schedule_fires_as_the_reference():
    """One rule list through both harnesses: the same invocations fire,
    with the same actions and messages."""
    rules = [dict(site="a", at=2, count=3), dict(site="b", at=1)]
    sites = ["a", "b", "a", "a", "b", "a", "a", "c"]
    logs = []
    for mod in (jfaults, sys.modules["repro_torch.testing.faults"]):
        raised = []
        with mod.inject(*[mod.FaultRule(**r) for r in rules]) as inj:
            for site in sites:
                try:
                    mod.fault_point(site)
                except mod.InjectedFault as e:
                    raised.append(str(e))
            logs.append((inj.fired(), raised,
                         [inj.invocations(s) for s in "abc"]))
    assert logs[0] == logs[1]
