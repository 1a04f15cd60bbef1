"""The manifest (`BENCHMARK.json`) and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own under `bench/`, found by its name:

* `configs/<config>.json`   — the model as it is run (`file` in the manifest),
  with what the checks hold it to: the published values (`published`), the
  keys cut (`reduced`) or forced by the program (`assumed`), the published
  keys the port names otherwise (`port_keys`), the expected `param_count`
  and `flops_per_token`
* `reference/<family>.py`   — the plain model the configuration names
* `traffic/<traffic>.json`  — the job: step, batch, sequence, optimizer
* `limits/<cell>.json`      — the limits that decide `correct` in that cell
* `metrics/<metric>.py`     — a reader: `read(run) -> float | None`

so a cell, a configuration or a metric is added by adding files and
entries, never by editing one that exists (the one exception: the new
cell's name appended to the `workloads` of the end-to-end rate it reports).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path=None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"bench_{tag}_{path.stem}".replace(
        "-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with the files it names, under `root`
    (the checkout's root by default)."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        self.manifest = manifest
        self.entry = find(manifest["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        self.bench = Path(root) / BENCH.name
        cfg_entry = find(manifest["configs"], self.entry["config"], "config")
        self.config_file = cfg_entry["file"]
        self.config = load_json(self.bench.parent / self.config_file)
        self.traffic = load_json(self.bench / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.bench / "limits" / f"{name}.json")

    def reference(self):
        """The plain model module the configuration names."""
        return reference_module(self.config["reference"], self.bench)

    def metrics(self, kind: str) -> list[dict]:
        """The manifest's `end_to_end` or `per_layer` metrics this cell
        reports: those that list it under `workloads`; without the key, an
        end-to-end metric is every cell's, and a per-layer one is every
        cell's that reports the end-to-end metric it moves."""
        e2e = {m["name"] for m in self.manifest["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        if kind == "end_to_end":
            return [m for m in self.manifest[kind] if m["name"] in e2e]
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name] if m["moves"] in e2e
                                      else [])]


def metric_reader(name: str):
    """`read(run) -> float | None` of `metrics/<name>.py`."""
    return _load_module(BENCH / "metrics" / f"{name}.py", "metric").read


def reference_module(family: str, bench: Path = BENCH):
    return _load_module(bench / "reference" / f"{family}.py", "reference")


def rms_norm_eps(config: dict, file: str) -> float:
    """The RMSNorm ε the reference runs, from a configuration's body (read
    from `file`): its `assumed` value where the program departs from the
    published one, else the published value."""
    for block in ("assumed", "published"):
        if "rms_norm_eps" in config.get(block, {}):
            return float(config[block]["rms_norm_eps"])
    raise KeyError(f"{file} states rms_norm_eps under neither `assumed` nor "
                   f"`published`")


def peaks(kind: str) -> dict:
    table = load_json(BENCH / "peaks.json")
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in bench/peaks.json")
    return table[kind]
