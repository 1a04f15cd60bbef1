"""AST determinism/perf lint over the port (counterpart of
`repro/analysis/lint.py`, DESIGN §13, layer 2).

The same seven rules, ids, messages and waiver syntax as the reference's,
so that a hit is waived once and seen by both gates; their path scopes are
the port's (`src/repro_torch/...`, and the port's timing driver
`chip_smoke.py`), `host-divergence` also knows torch's spelling of process
identity (`torch.distributed.get_rank` / `get_world_size`), and
`unfenced-timing` takes the port's fences: `torch.cuda.synchronize()`,
or `.synchronize()` on an event or a stream.

Each rule is a plugin registered with `@register_rule`: a pure function
from a parsed module to `(line, message)` findings, plus a path scope
(some hazards are only hazards in certain code — wall-clock reads are fine
in the training loop but not inside traced step code).  Intentional hits
are waived inline:

    something_hazardous()  # repro: allow(<rule-id>) — <reason>

(on the offending line or the line directly above).  Waived findings stay
in the report, flagged, but never fail the gate.

The rule set encodes this repo's actual regression history:

* ``hash-seed``       — `hash(name)` once seeded per-host RNGs; str hashes
                        are PYTHONHASHSEED-randomized per process, so every
                        host materialized a different batch.  `id()` is
                        equally run-dependent.
* ``wallclock-traced``— a `time.*` / `datetime.now` read inside traced or
                        fault-deterministic code either burns a host sync
                        or (under `REPRO_FAULTS`) breaks replayability.
* ``bare-interpret``  — a literal `interpret=True` pins a Pallas kernel to
                        host interpret mode on every backend; the backend
                        decision belongs to `kernels.resolve_interpret`.
* ``set-iter-order``  — iterating a set feeds PYTHONHASHSEED-dependent
                        order into whatever consumes it; traced code turns
                        that into per-process graph topologies (cache-key
                        and compiled-executable desync across hosts).
* ``unfenced-timing`` — wall-clock spans around async dispatch once
                        measured dispatch, not work.  A timing function
                        that reads the clock twice must fence with
                        `torch.cuda.synchronize` (or an event's or a
                        stream's `synchronize`).
* ``nonatomic-write`` — checkpoint/coordination files must be written
                        tmp-then-`os.replace` (crash atomicity, DESIGN
                        §12); `os.rename` fails on an existing target on
                        Windows and a plain in-place `open(..., "w")` can
                        be torn by a crash mid-write.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding

WAIVER_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*([a-zA-Z0-9_,\- ]+?)\s*\)\s*(?:[—–-]+\s*(.*))?$")

_RULES: list["LintRule"] = []


class LintRule:
    def __init__(self, rule_id: str, check, scope=None, doc: str = ""):
        self.id = rule_id
        self.check = check           # (tree, src, relpath) -> [(line, msg)]
        self.scope = scope           # (relpath: str) -> bool; None = all
        self.doc = doc

    def applies(self, relpath: str) -> bool:
        return self.scope is None or self.scope(relpath)


def register_rule(rule_id: str, scope=None):
    def deco(fn):
        _RULES.append(LintRule(rule_id, fn, scope, fn.__doc__ or ""))
        return fn
    return deco


def rules() -> list[LintRule]:
    return list(_RULES)


# --------------------------------------------------------------- helpers ----

def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target: `time.monotonic`, `hash`, `os.replace`
    (best-effort; non-name targets come back empty)."""
    parts: list[str] = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


_WALLCLOCK = {"time.time", "time.monotonic", "time.perf_counter",
              "time.process_time", "time.time_ns", "time.monotonic_ns",
              "time.perf_counter_ns", "time.sleep",
              "datetime.now", "datetime.utcnow", "datetime.today",
              "datetime.datetime.now", "datetime.datetime.utcnow"}
# reads only (not sleep): what a timing span is made of
_CLOCK_READS = _WALLCLOCK - {"time.sleep"}


def _func_ranges(tree, name: str):
    """(start, end) line ranges of every function literally named `name`."""
    return [(n.lineno, n.end_lineno) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == name]


def _in_ranges(line: int, ranges) -> bool:
    return any(a <= line <= b for a, b in ranges)


def _path_in(*prefixes):
    norm = tuple(p.rstrip("/") for p in prefixes)
    return lambda rel: any(rel == p or rel.startswith(p + "/") for p in norm)


# ----------------------------------------------------------------- rules ----

@register_rule("hash-seed")
def _hash_seed(tree, src, relpath):
    """`hash()`/`id()` values are per-process (PYTHONHASHSEED / allocator):
    using them in seeds, cache keys, or filenames desyncs hosts.  Bodies of
    `__hash__` are exempt (delegating to `hash()` there is the protocol);
    anything else needs a waiver or a stable digest (`zlib.crc32`,
    `hashlib`)."""
    exempt = _func_ranges(tree, "__hash__")
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("hash", "id")
                and not _in_ranges(node.lineno, exempt)):
            out.append((node.lineno,
                        f"{node.func.id}() is PYTHONHASHSEED/run-dependent; "
                        f"use a stable digest (zlib.crc32, hashlib) for "
                        f"seeds and cache keys"))
    return out


_TRACED_SCOPE = _path_in(
    "src/repro_torch/kernels", "src/repro_torch/models",
    "src/repro_torch/optim", "src/repro_torch/core", "src/repro_torch/data",
    "src/repro_torch/distributed/train_step.py",
    "src/repro_torch/distributed/local_step.py",
    "src/repro_torch/distributed/serve_step.py",
    "src/repro_torch/distributed/flatbuf.py",
    "src/repro_torch/distributed/params.py",
    "src/repro_torch/distributed/sharding.py",
    "src/repro_torch/testing/faults.py",
)


@register_rule("wallclock-traced", scope=_TRACED_SCOPE)
def _wallclock_traced(tree, src, relpath):
    """Wall-clock reads inside traced step code or the fault-deterministic
    harness: a traced `time.*` runs once at trace time (a silent constant),
    a host-side one syncs the device, and under `REPRO_FAULTS` any
    wall-clock dependence breaks deterministic replay."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) in _WALLCLOCK:
            out.append((node.lineno,
                        f"{_call_name(node)}() in traced/fault-deterministic "
                        f"code; thread times in as data or waive"))
    return out


_HOST_IDENTITY = {"jax.process_index", "process_index",
                  "jax.process_count", "process_count",
                  "jax.host_id", "host_id",
                  "socket.gethostname", "platform.node",
                  "os.getpid", "uuid.uuid4",
                  "torch.distributed.get_rank", "dist.get_rank",
                  "torch.distributed.get_world_size", "dist.get_world_size"}


@register_rule("host-divergence", scope=_TRACED_SCOPE)
def _host_divergence(tree, src, relpath):
    """Host-identity reads (process index/count, hostname, pid, uuid4)
    inside traced-scope code: a value that differs per rank feeding a
    traced computation produces per-rank graphs — ranks then disagree on
    collective order and deadlock (the SPMD-divergence class layer 3's
    `divergence.py` checks dynamically; this is the lexical half).
    Rank-dependent *data* belongs in collectives; rank-dependent
    *structure* is always a bug."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) in _HOST_IDENTITY:
            out.append((node.lineno,
                        f"{_call_name(node)}() is a per-rank value in "
                        f"traced-scope code; rank-dependent structure "
                        f"desyncs SPMD programs — hoist it to the launch "
                        f"layer or waive"))
    return out


@register_rule("bare-interpret",
               scope=lambda rel: rel != "src/repro_torch/kernels/__init__.py")
def _bare_interpret(tree, src, relpath):
    """A literal `interpret=True` forces host interpret mode on every
    backend.  The backend decision belongs to `kernels.resolve_interpret`
    (explicit flag > REPRO_PALLAS_INTERPRET > autodetect) — pass its
    result instead."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if (kw.arg == "interpret"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    out.append((kw.value.lineno,
                                "bare interpret=True; route through "
                                "kernels.resolve_interpret"))
    return out


def _is_set_expr(node) -> bool:
    return (isinstance(node, (ast.Set, ast.SetComp))
            or (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("set", "frozenset")))


@register_rule("set-iter-order")
def _set_iter_order(tree, src, relpath):
    """Iterating a set literal / set() result feeds PYTHONHASHSEED-dependent
    order downstream; in trace-adjacent code that means per-process graph
    topologies and cache keys.  Wrap the iterable in `sorted(...)`."""
    out = []
    iters = [n.iter for n in ast.walk(tree) if isinstance(n, ast.For)]
    iters += [gen.iter for n in ast.walk(tree)
              if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp))
              for gen in n.generators]
    for it in iters:
        if _is_set_expr(it):
            out.append((it.lineno,
                        "iteration order of a set is PYTHONHASHSEED-"
                        "dependent; wrap in sorted(...)"))
    return out


@register_rule("unfenced-timing", scope=_path_in("chip_smoke.py"))
def _unfenced_timing(tree, src, relpath):
    """A timing function that reads the clock more than once is timing a
    span; without a `torch.cuda.synchronize` fence (or an event's or a
    stream's `synchronize()`) the span measures async dispatch, not device
    work (the prefill-timing leak).  Functions with a single read
    (timestamping) are fine."""
    out = []

    class V(ast.NodeVisitor):
        def _do_func(self, node):
            reads, fenced = [], False
            stack = list(ast.iter_child_nodes(node))
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._do_func(n)       # nested functions fence themselves
                    continue
                if isinstance(n, ast.Call):
                    name = _call_name(n)
                    if name in _CLOCK_READS:
                        reads.append(n.lineno)
                    if name.endswith("synchronize"):
                        fenced = True
                if isinstance(n, ast.Attribute) and n.attr == "synchronize":
                    fenced = True
                stack.extend(ast.iter_child_nodes(n))
            if len(reads) >= 2 and not fenced:
                out.append((min(reads),
                            f"{len(reads)} clock reads with no "
                            f"synchronize fence in this function; the "
                            f"span times dispatch, not device work"))

        def visit_FunctionDef(self, node):
            self._do_func(node)

        visit_AsyncFunctionDef = visit_FunctionDef

    V().visit(tree)
    return out


_DURABLE_SCOPE = _path_in("src/repro_torch/checkpoint",
                          "src/repro_torch/distributed/coordination.py")


@register_rule("nonatomic-write", scope=_DURABLE_SCOPE)
def _nonatomic_write(tree, src, relpath):
    """Checkpoint/coordination files must land atomically: write a temp
    sibling, fsync, `os.replace` (DESIGN §12).  `os.rename` is not atomic
    over an existing target on all platforms, and an in-place
    `open(path, "w")` with no `os.replace` in the same function tears the
    previous contents on a crash mid-write."""
    out = []

    def write_mode(call: ast.Call) -> bool:
        if _call_name(call) not in ("open", "io.open"):
            return False
        mode = None
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
            mode = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        return isinstance(mode, str) and any(c in mode for c in "wxa")

    class V(ast.NodeVisitor):
        def _do_func(self, node):
            writes, atomic = [], False
            stack = list(ast.iter_child_nodes(node))
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._do_func(n)
                    continue
                if isinstance(n, ast.Call):
                    name = _call_name(n)
                    if name == "os.rename":
                        out.append((n.lineno,
                                    "os.rename is not atomic over an "
                                    "existing target everywhere; use "
                                    "os.replace"))
                    if name in ("os.replace", "os.fsync"):
                        atomic = True
                    if write_mode(n):
                        writes.append(n.lineno)
                stack.extend(ast.iter_child_nodes(n))
            if writes and not atomic:
                for line in writes:
                    out.append((line,
                                "in-place write with no os.replace in this "
                                "function; write a temp sibling and "
                                "os.replace it (crash atomicity)"))

        def visit_FunctionDef(self, node):
            self._do_func(node)

        visit_AsyncFunctionDef = visit_FunctionDef

    V().visit(tree)
    return out


# ---------------------------------------------------------------- driver ----

def _waivers(src_lines) -> dict:
    """line -> (set of waived rule ids, reason) for every waiver comment."""
    out = {}
    for i, line in enumerate(src_lines, 1):
        m = WAIVER_RE.search(line)
        if m:
            ids = {p.strip() for p in m.group(1).split(",")}
            out[i] = (ids, (m.group(2) or "").strip())
    return out


def lint_file(path, root=None) -> list[Finding]:
    """All rule findings for one file, waivers applied (a waiver on the
    finding's line or the line directly above suppresses it)."""
    path = Path(path)
    rel = str(path.relative_to(root)) if root else str(path)
    src = path.read_text()
    tree = ast.parse(src, filename=str(path))
    lines = src.splitlines()
    waivers = _waivers(lines)
    findings = []
    for r in _RULES:
        if not r.applies(rel):
            continue
        for line, msg in r.check(tree, lines, rel):
            waived, reason = False, ""
            for probe in (line, line - 1):
                w = waivers.get(probe)
                if w and (r.id in w[0] or "all" in w[0]):
                    waived, reason = True, w[1]
                    break
            findings.append(Finding(rule=r.id, layer="lint",
                                    location=f"{rel}:{line}", message=msg,
                                    waived=waived, waiver_reason=reason))
    return sorted(findings, key=lambda f: f.location)


LINT_PATHS = ("src/repro_torch", "chip_smoke.py")


def lint_paths(root, paths=LINT_PATHS) -> list[Path]:
    """The Python files the port's lint walks under `root`: every one under
    its package, and its timing driver (tests and fixtures are
    deliberately out of scope — they assert on hazards)."""
    root = Path(root)
    out = []
    for sub in paths:
        base = root / sub
        if base.is_file():
            out.append(base)
        elif base.exists():
            out.extend(sorted(base.rglob("*.py")))
    return out


def run_lint(root, paths=LINT_PATHS) -> list[Finding]:
    """Lint the port's files under `root` (`lint_paths`)."""
    return [f for path in lint_paths(root, paths)
            for f in lint_file(path, root=root)]


__all__ = ["LINT_PATHS", "LintRule", "WAIVER_RE", "lint_file", "lint_paths",
           "register_rule", "rules", "run_lint"]
