"""The port's AST lint (`repro_torch.analysis.lint`) against the
reference's: the same rules fire at the same lines with the same messages
and waivers on the reference's fixtures moved to the port's paths, the
registry is the same seven rules, and the port itself is lint-clean.

The fixtures (`tests/fixtures/lint/**`) are copied into a temporary tree
at the port's relative paths (`src/repro/x` -> `src/repro_torch/x`,
`benchmarks/leaky.py` -> `chip_smoke.py` with its fence written in
torch); the originals are linted where they lie by the reference.
"""

import pathlib
import shutil

import pytest

from repro.analysis.lint import lint_file as ref_lint_file
from repro.analysis.lint import rules as ref_rules
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.lint import (
    LINT_PATHS, WAIVER_RE, lint_file, lint_paths, rules, run_lint)

FIXROOT = pathlib.Path(__file__).parent / "fixtures" / "lint"
REPO = pathlib.Path(__file__).parent.parent

# the port's relpath of each fixture
PORT_PATHS = {
    "src/repro/core/hash_cache.py": "src/repro_torch/core/hash_cache.py",
    "src/repro/kernels/clocked.py": "src/repro_torch/kernels/clocked.py",
    "src/repro/models/rank_branch.py": "src/repro_torch/models/rank_branch.py",
    "src/repro/kernels/pinned.py": "src/repro_torch/kernels/pinned.py",
    "src/repro/core/set_order.py": "src/repro_torch/core/set_order.py",
    "benchmarks/leaky.py": "chip_smoke.py",
    "src/repro/checkpoint/torn.py": "src/repro_torch/checkpoint/torn.py",
}
# the reference's fence, written the port's way on the same line
FENCE = ("jax.block_until_ready(step(*args))",
         "torch.cuda.synchronize() or step(*args)")


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lint_port")
    for ref_rel, port_rel in PORT_PATHS.items():
        src = (FIXROOT / ref_rel).read_text()
        if ref_rel == "benchmarks/leaky.py":
            assert FENCE[0] in src
            src = src.replace(FENCE[0], FENCE[1]).replace(
                "def fenced_span(step, args, jax):",
                "def fenced_span(step, args, torch):")
        dst = root / port_rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src)
    return root


def _key(f):
    """(rule, line, message, waived, reason) of a finding, its message with
    the fence named the reference's way."""
    return (f.rule, int(f.location.rsplit(":", 1)[1]),
            f.message.replace("synchronize fence", "block_until_ready fence"),
            f.waived, f.waiver_reason)


@pytest.mark.parametrize("ref_rel", sorted(PORT_PATHS))
def test_port_findings_equal_reference_on_fixtures(port_tree, ref_rel):
    """Rule, line, message and waiver of every finding equal the
    reference's lint of the original file."""
    want = [_key(f) for f in ref_lint_file(FIXROOT / ref_rel, root=FIXROOT)]
    got = [_key(f) for f in lint_file(port_tree / PORT_PATHS[ref_rel],
                                      root=port_tree)]
    assert want, ref_rel
    assert got == want


def test_scopes_are_the_ports(port_tree, tmp_path):
    """The path-scoped rules fire on the port's paths and not on the
    reference's: the clocked fixture under `launch/` (outside the traced
    scope) and the leaky timing file anywhere but `chip_smoke.py` are
    clean, and `bare-interpret` spares `src/repro_torch/kernels/__init__.py`."""
    clocked = (FIXROOT / "src/repro/kernels/clocked.py").read_text()
    leaky = (FIXROOT / "benchmarks/leaky.py").read_text()
    pinned = (FIXROOT / "src/repro/kernels/pinned.py").read_text()
    for rel, src, rule in (
            ("src/repro_torch/launch/clocked.py", clocked, "wallclock-traced"),
            ("src/repro/kernels/clocked.py", clocked, "wallclock-traced"),
            ("benchmarks/leaky.py", leaky, "unfenced-timing"),
            ("src/repro_torch/kernels/__init__.py", pinned, "bare-interpret")):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        assert not [f for f in lint_file(path, root=tmp_path)
                    if f.rule == rule], rel


def test_torch_rank_reads_are_host_divergence(tmp_path):
    """The torch spelling of process identity is a per-rank read in traced
    scope, with or without the `dist.` prefix; the same lines outside the
    scope are clean."""
    src = ("import torch\nimport torch.distributed as dist\n\n\n"
           "def depth(x):\n"
           "    if torch.distributed.get_rank() == 0:\n"
           "        return x * dist.get_world_size()\n"
           "    return x + dist.get_rank()\n")
    for rel, n in (("src/repro_torch/models/ranked.py", 3),
                   ("src/repro_torch/launch/ranked.py", 0)):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        got = [f for f in lint_file(path, root=tmp_path)
               if f.rule == "host-divergence"]
        assert [int(f.location.rsplit(":", 1)[1]) for f in got] == \
            ([6, 7, 8] if n else []), rel


def test_fences_the_port_accepts(tmp_path):
    """`torch.cuda.synchronize()` and `.synchronize()` on an event or a
    stream fence a timing span in `chip_smoke.py`."""
    body = ("import time\nimport torch\n\n\n"
            "def span(step, ev):\n"
            "    t0 = time.perf_counter()\n"
            "    step()\n"
            "    {fence}\n"
            "    return time.perf_counter() - t0\n")
    path = tmp_path / "chip_smoke.py"
    for fence, flagged in (("pass", True), ("torch.cuda.synchronize()", False),
                           ("ev.synchronize()", False),
                           ("torch.cuda.current_stream().synchronize()", False)):
        path.write_text(body.format(fence=fence))
        assert bool([f for f in lint_file(path, root=tmp_path)
                     if f.rule == "unfenced-timing"]) == flagged, fence


def test_rule_registry_is_the_references():
    """The seven rule ids, each with a doc."""
    assert [r.id for r in rules()] == [r.id for r in ref_rules()]
    assert {r.id for r in rules()} == {
        "hash-seed", "wallclock-traced", "host-divergence", "bare-interpret",
        "set-iter-order", "unfenced-timing", "nonatomic-write"}
    assert all(r.doc for r in rules())


def test_waiver_grammar_is_the_references():
    from repro.analysis.lint import WAIVER_RE as REF_WAIVER_RE
    assert WAIVER_RE.pattern == REF_WAIVER_RE.pattern


def test_port_is_lint_clean():
    """THE gate invariant over the port: `src/repro_torch` and
    `chip_smoke.py` carry zero unwaived findings, and every waiver has a
    reason."""
    assert LINT_PATHS == ("src/repro_torch", "chip_smoke.py")
    files = lint_paths(REPO)
    assert REPO / "chip_smoke.py" in files
    assert any(f.name == "graph_check.py" for f in files)
    findings = run_lint(REPO)
    active = [f for f in findings if not f.waived]
    assert not active, "\n".join(f.render() for f in active)
    assert all(f.waiver_reason for f in findings if f.waived)
    # the TP collectives' timing is the known waived hit in traced scope
    assert any(f.location.startswith("src/repro_torch/distributed/sharding.py")
               and f.rule == "wallclock-traced" for f in findings)


def test_cli_lint_only_strict(capsys, tmp_path):
    """`python -m repro_torch.analysis --skip-graph --strict` lints and
    passes on the repo, and fails on a tree with a planted hit."""
    assert cli.main(["--skip-graph", "--strict", "--root", str(REPO)]) == 0
    planted = tmp_path / "src/repro_torch/core/keyed.py"
    planted.parent.mkdir(parents=True)
    shutil.copy(FIXROOT / "src/repro/core/hash_cache.py", planted)
    assert cli.main(["--skip-graph", "--strict", "--root", str(tmp_path)]) == 1
    assert "hash-seed" in capsys.readouterr().out


def test_report_equals_the_references():
    """The same findings render to the same text and JSON in both
    packages (waived ones flagged, cost lines included; the port's
    in-place count stands where the reference's donation count does)."""
    from repro.analysis.findings import Finding as RefFinding
    from repro.analysis.findings import render_report as ref_render
    from repro_torch.analysis.findings import Finding, render_report
    rows = [("hash-seed", "lint", "src/x.py:3", "id() is run-dependent", False, ""),
            ("wallclock-traced", "lint", "src/y.py:9", "clock", True, "fixture"),
            ("pack-count", "graph", "fsdp_norm/flat/flat", "packs=2", False, "")]
    metrics = {"v": {"collectives": {"psum": {"count": 2, "bytes": 16}},
                     "flatbuf": {"count": 1, "bytes": 8}, "flops": 10,
                     "peak_bytes": 64, "inplace": 3, "donated_aliased": 3}}
    checked = {"cost": {"metrics": metrics}, "variants": ["v"]}
    for as_json in (False, True):
        assert render_report([Finding(*r) for r in rows], checked=checked,
                             as_json=as_json) == \
            ref_render([RefFinding(*r) for r in rows], checked=checked,
                       as_json=as_json)
