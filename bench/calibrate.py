"""The readings the limits of `correct` are set from (PERF.md §2), for one
cell, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault half_batch --fault no_exchange \
         --fault-seeds ...] [--out F]

For each seed of `--seeds`: the program's check steps (set-up and the
cell's first steps, no window) against the plain reference — the sound
runs, whose largest reading is a number's lower reading.  For each of
`--control-seeds`: the reference computed with its float32 products on the
TF32 tensor cores, put in the program's place (the control).  For each
`--fault` and each of `--fault-seeds`: the program with that fault planted.
Every program run comes first, the references after them: a reference's
memory left on a card would not leave a four-card cell's ranks room.  One
JSON line a reading, to standard output and `--out`.
"""

import os
import sys
import time

T_PROCESS = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def main(argv=None):
    import argparse
    import gc
    import json

    import torch

    from benchkit import compare
    from benchkit.cli import ranks, reference_check
    from benchkit.manifest import Cell, load_manifest
    from benchkit.program import Spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[],
                   choices=("half_batch", "no_exchange"))
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    cell = Cell(load_manifest(), a.workload)
    device = torch.device(a.device or "cuda")
    out = open(a.out, "a") if a.out else None

    def emit(kind, seed, prog, ref, secs):
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           "seconds": round(secs, 2), **compare.readings(prog, ref),
                           "worst": compare.worst_leaves(prog, ref),
                           "program": {k: prog[k] for k in ("loss", "var_l1", "grad_sqnorm", "T")},
                           "reference": {k: ref[k] for k in ("loss", "var_l1", "grad_sqnorm", "T")}})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def spec(seed, fault=""):
        return Spec(cell=cell.name, config=cell.config, traffic=cell.traffic,
                    seed=seed, seconds=0, trace=False, t_process=T_PROCESS,
                    device=a.device, smoke=a.smoke, fault=fault)

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    refs = {}

    def ref(seed, tf32=False):
        key = (seed, tf32)
        if key not in refs:
            t = time.time()
            refs[key] = (reference_check(cell, spec(seed), device, tf32=tf32),
                         time.time() - t)
            free()
        return refs[key]

    runs = [("sound", seed, "") for seed in seeds(a.seeds)]
    runs += [(f, seed, f) for f in a.fault for seed in seeds(a.fault_seeds)]
    progs = []
    for kind, seed, fault in runs:
        t = time.time()
        progs.append((kind, seed, ranks(spec(seed, fault), cell.chips)[0]["check"],
                      time.time() - t))
        free()
    for kind, seed, prog, secs in progs:
        r, r_secs = ref(seed)
        emit(kind, seed, prog, r, secs + r_secs)
    for seed in seeds(a.control_seeds):
        (c, c_secs), (r, r_secs) = ref(seed, True), ref(seed)
        emit("control_tf32", seed, c, r, c_secs + r_secs)
    if out:
        out.close()


if __name__ == "__main__":
    main()
