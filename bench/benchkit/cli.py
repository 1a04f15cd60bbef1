"""`python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`:
one run of one cell on the card(s), its result as the last line of
standard output.

The run: set-up and check steps on every rank, the measured window, the
trace's reduction (`--trace 1`), the program's state freed, then the
plain reference over the check steps and the comparison that decides
`correct`; the numbers compared go, each beside its limit, to the last
lines of standard error and under the result's last key, `checks`.  A
run in which any rank's process, or this one, has loaded JAX or the JAX
package by the window's close is refused with no result.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_forbidden(modules=None) -> list[str]:
    """Modules of JAX or of the JAX package among `modules` (default: this
    process's), by top-level name compared whole (`repro_torch` is not
    `repro`)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU at the configurations' smoke sizes, and planted faults: for
    # the benchmark's own tests, never for a measurement
    p.add_argument("--device", default="", help=argparse.SUPPRESS)
    p.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--fault", default="",
                   choices=("", "half_batch", "unchanged", "no_exchange", "jax_in_rank"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def ranks(spec, world: int) -> list[dict]:
    """Every rank's record: this process alone on one card, else `world`
    spawned ranks (NCCL, one card each; gloo on the CPU)."""
    from benchkit.program import run_rank, run_ranks
    if world == 1:
        return [run_rank(spec)]
    from repro_torch.launch.mesh import spawn_workers
    return spawn_workers(run_ranks, world, spec,
                         backend="gloo" if spec.device == "cpu" else "nccl")


def _cards(device, chips: int):
    """The devices the reference spreads its layers over: the cell's cards
    (the program's state is freed by then)."""
    import torch
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(chips)]


def reference_check(cell, spec, device, tf32: bool = False) -> dict:
    """The reference's numbers over the cell's check steps, from the seed
    (`tf32`: the control, its float32 products on the TF32 tensor cores)."""
    from benchkit.manifest import rms_norm_eps
    from benchkit.program import family_shapes, model_dict, traffic_dict
    from benchkit.refstep import run_reference
    from benchkit.traffic import MarkovTokens, learning_rate, make_batch
    m = model_dict(cell.config, spec.smoke)
    tr = traffic_dict(cell.traffic, spec.smoke)
    source = MarkovTokens(m["vocab_size"], spec.seed, tr["fan_out"])
    n, gb = tr["check_steps"], tr["global_batch"]
    rows = tr["workers"] * tr["micro_batch"]
    batches = [make_batch(source, k, tr["accum"], rows, tr["seq_len"]) for k in range(n)]
    start = tr["lr_schedule"]["samples_start"]
    lrs = [learning_rate(start + k * gb, tr["optimizer"], tr["lr_schedule"])
           for k in range(n)]
    eps = rms_norm_eps(cell.config, cell.config_file)
    return run_reference(cell.reference(), m, eps,
                         cell.config["init"], family_shapes(cell.config, m),
                         spec.seed, batches, lrs, tr, device, tf32=tf32,
                         devices=_cards(device, cell.chips))


def run(argv=None, t_process: float | None = None,
        manifest: dict | None = None) -> tuple[int, dict | None]:
    """One run; (exit code, result).  `manifest`: BENCHMARK.json's by
    default."""
    import time

    import torch

    from benchkit import compare
    from benchkit.manifest import Cell, load_manifest, metric_reader, peaks
    from benchkit.program import Spec, model_dict, traffic_dict

    t_process = time.time() if t_process is None else t_process
    args = parse(argv)
    cell = Cell(manifest or load_manifest(), args.workload)
    if not args.device:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2, None
    spec = Spec(cell=cell.name, config=cell.config, traffic=cell.traffic,
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                t_process=t_process, device=args.device, smoke=args.smoke,
                fault=args.fault)
    recs = ranks(spec, cell.chips)
    bad = sorted({n for r in recs for n in r["forbidden"]})
    if bad:
        print(f"JAX or the JAX package was loaded in a rank's process: {bad}",
              file=sys.stderr)
        return 3, None
    lead = recs[0]
    device = torch.device(args.device or "cuda")
    ref = reference_check(cell, spec, device)
    values = compare.readings(lead["check"], ref)
    correct, checks = compare.verdict(values, cell.limits["limits"])

    m = model_dict(cell.config, spec.smoke)
    tr = traffic_dict(cell.traffic, spec.smoke)
    family = cell.reference()
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    view = {
        "chips": cell.chips, "trace": spec.trace,
        "setup_s": max(r["setup_s"] for r in recs),
        "steps": lead["steps"], "t_start": lead["t_start"],
        "t_untraced": lead["t_untraced"],
        "flops_per_token": family.flops_per_token(m, tr["seq_len"]),
        "peaks": peaks(kind) if device.type == "cuda" else None,
        "peak_mem_bytes": [r["peak_mem_bytes"] for r in recs],
        "traces": [r["trace"] for r in recs],
        "flat_elements": [r["flat_elements"] for r in recs],
        "full_elements": lead["full_elements"],
    }
    metrics = {}
    for entry in cell.metrics("per_layer" if spec.trace else "end_to_end"):
        value = metric_reader(entry["name"])(view)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    peak_bytes = [p for p in view["peak_mem_bytes"] if p is not None]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips,
           "memory_peak_bytes": max(peak_bytes) if peak_bytes else 0}
    result = {"correct": correct, "attempted": len(lead["steps"]),
              "failed": sum(not math.isfinite(s["loss"]) for s in lead["steps"]),
              "metrics": metrics, "device": dev}
    traces = [t for t in view["traces"] if t]
    if spec.trace and traces:
        dev["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        dev["window_s"] = traces[0]["window_s"]
        result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                               "idle_gaps": traces[0]["idle_gaps"]}
    result["checks"] = checks
    return 0, result


def main(argv=None, t_process: float | None = None) -> int:
    code, result = run(argv, t_process)
    if result is None:
        return code
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
