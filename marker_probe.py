#!/usr/bin/env python3
"""Time the flat-layout marker (`repro_torch::layout_marker`) on one card,
for one or more checkouts of this repository in turns.

    python3 marker_probe.py [TREE ...]     # default: this checkout

Each TREE is the root of a checkout (for instance a parent commit unpacked
with `git archive` into a git-ignored directory).  Each is run in a fresh
process that imports that tree's `src/repro_torch`, builds its kernels and
prints one JSON line:

- the ACCUM-NORM step with flat statistics and flat parameters (the
  training phases' path) on full-width microllama-300m, micro 4 x 512
  tokens, 2 microbatches: after 3 warm-up steps, 20 steps, each with the
  host's seconds until the step returns (`host_ms`), CUDA events around
  it (`device_ms`) and the host's seconds until the card is done with it
  (`wall_ms`), and the losses (equal in every tree);
- the marker events one step dispatches, counted by a dispatch mode on a
  step of its own (null in a tree without the marker);
- the marker's own cost: 20 000 calls over the step's parameter buffers,
  host microseconds a call (null in a tree without the marker).

Trees listed in turns (A B B A) compare on one card.  Needs a CUDA card;
fails without one.
"""

import json
import subprocess
import sys
from pathlib import Path

WARMUP, STEPS, MARKER_CALLS = 3, 20, 20_000


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import statistics
    import time

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat

    if not torch.cuda.is_available():
        raise RuntimeError("marker_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))

    model = build_model(get_config("microllama-300m"))
    params = model.init(0, dev)
    wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl="flat",
                                params_impl="flat", params_like=params, device=dev)
    layout = wrap.flat_layout
    opt = init_adamw_flat(params, layout=layout, device=dev)
    pb = tuple(layout.flatten(params))
    del params
    plan = BatchPlan(global_batch=8, micro_batch=4, accum_steps=2, workers=1)
    src = MarkovTokens(vocab_size=model.cfg.vocab_size, seed=0)
    batches = [make_batch(src, t, plan, 512) for t in range(WARMUP + STEPS + 1)]
    step = wrap(batches[0])

    host, device, wall, losses = [], [], [], []
    for t, b in enumerate(batches[:WARMUP + STEPS]):
        batch = batch_to_device(b, dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        pb, opt, met = step(pb, opt, batch, 1e-4)
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if t >= WARMUP:
            host.append(1e3 * (t1 - t0))
            device.append(start.elapsed_time(end))
            wall.append(1e3 * (t2 - t0))
        losses.append(float(met["loss"]))

    marker = getattr(torch.ops.repro_torch, "layout_marker", None) \
        if hasattr(torch.ops, "repro_torch") else None
    events = per_call_us = None
    if marker is not None:
        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is marker.default:
                    self.n += 1
                return func(*args, **(kwargs or {}))

        counter = Count()
        with counter:
            pb, opt, met = step(pb, opt, batch_to_device(batches[-1], dev), 1e-4)
        torch.cuda.synchronize()
        events = counter.n
        bufs = list(pb)
        for _ in range(100):
            marker.default(bufs, "pack", layout.num_leaves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MARKER_CALLS):
            marker.default(bufs, "pack", layout.num_leaves)
        torch.cuda.synchronize()
        per_call_us = 1e6 * (time.perf_counter() - t0) / MARKER_CALLS

    def summary(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    return {"tree": str(tree), "buffers": layout.num_buffers,
            "leaves": layout.num_leaves, "steps": STEPS,
            "host_ms": summary(host), "device_ms": summary(device),
            "wall_ms": summary(wall), "losses": losses,
            "marker_events_a_step": events, "marker_us_a_call": per_call_us}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for tree in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
