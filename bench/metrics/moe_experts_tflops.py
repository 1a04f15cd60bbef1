"""The held experts' batched SwiGLU as a rate: the products the program's
`model.moe.experts` spans run in a traced step, forward and recompute, over
the device time launched inside them, on the slowest rank (TFLOP/s, 1e12).
The backward's own kernels stay in `backward_ms`.  A rate with no peak.

The products are counted from the configuration and the traffic of the one
cell that lists this metric (`expert_flops_per_step`), not read from the
program.  None where the program records no such span."""

from benchkit.manifest import Cell, find, load_manifest

NAME = "model.moe.experts"


def expert_flops_per_step(m: dict, tr: dict) -> float:
    """6 · rows · d_model · d_expert (gate, up and down) in every MoE layer,
    every microbatch, once forward and once more recomputed under remat
    "full": rows = the held experts × their capacity C = ⌊factor · t ·
    top_k / the router's width⌋ a row × a microbatch's rows."""
    e, t = m["moe"], tr["seq_len"]
    width = e.get("router_experts") or e["num_experts"]
    cap = max(min(int(e["capacity_factor"] * t * e["top_k"] / width), t), 1)
    rows = e["num_experts"] * cap * tr["micro_batch"]
    layers = m["num_layers"] - e.get("first_dense", 0)
    passes = 2 if m.get("remat") == "full" else 1
    return 6.0 * rows * m["d_model"] * e["d_expert"] * layers * tr["accum"] * passes


def read(run):
    traces = [t for t in run["traces"] if t and t.get("by_span", {}).get(NAME, 0) > 0]
    manifest = load_manifest()
    cells = find(manifest["per_layer"], "moe_experts_tflops", "metric").get("workloads", [])
    if not traces or len(cells) != 1:
        return None
    cell = Cell(manifest, cells[0])
    flops = expert_flops_per_step(cell.config["model"], cell.traffic)
    return min(flops * t["steps"] / t["by_span"][NAME] for t in traces) / 1e12
