"""Figure 2 analog through the port: adaptive vs constant vs stagewise
batch-size schedules on the same model/data — training loss, validation
loss and the batch-size trajectory (counterpart of
`examples/batch_schedule_comparison.py`).

    PYTHONPATH=src python examples/torch_batch_schedule_comparison.py [--steps N] [--device cpu]

Expected outcome (mirrors paper Figure 2 / Table 1):
  * constant-large trains fastest per step but worst val loss;
  * constant-small best val loss but most steps;
  * adaptive starts small and grows, landing near small-batch loss with
    near-large-batch efficiency.
Writes experiments/schedule_comparison_torch.csv.  Runs on the CUDA card
unless `--device cpu`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.train import TrainJob, run_training, summarize  # noqa: E402

SCHEMES = {
    "adaptive_eta0.1": dict(schedule="adaptive", eta=0.1),
    "adaptive_eta0.2": dict(schedule="adaptive", eta=0.2),
    "constant_4": dict(schedule="constant", base_global_batch=4,
                       max_global_batch=4),
    "constant_64": dict(schedule="constant", base_global_batch=64,
                        max_global_batch=64),
    "stagewise_2.5-2.5-95": dict(schedule="stagewise",
                                 stages=((0.025, 4), (0.025, 16), (0.95, 64))),
}
CSV = "experiments/schedule_comparison_torch.csv"


def scheme_job(name: str, steps: int, arch: str = "microllama-300m") -> dict:
    """The reference example's TrainJob fields of one scheme: every scheme
    gets the same sample budget, steps * 64."""
    base = dict(arch=arch, steps=10**9, total_samples=steps * 64,
                seq_len=64,
                base_global_batch=4, max_global_batch=64, base_micro_batch=2,
                max_micro_batch=4, base_accum=2, step_impl="accum_norm",
                eval_every=max(steps // 3, 1), eval_batches=2)
    base.update(SCHEMES[name])
    return base


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60,
                        help="sample budget = steps * 64 (every scheme gets "
                             "the same samples, like the paper's Tables 1-3)")
    parser.add_argument("--arch", default="microllama-300m")
    parser.add_argument("--device", default="", choices=("", "cuda", "cpu"),
                        help="the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)

    rows, hists = [], {}
    for name in SCHEMES:
        hist = run_training(TrainJob(**scheme_job(name, args.steps, args.arch),
                                     device=args.device))
        s = summarize(hist)
        rows.append((name, s))
        hists[name] = hist
        print(f"{name:24s} steps={s['steps']:3d} avg_bsz={s['avg_batch']:6.1f} "
              f"loss={s['best_loss']:.3f} val={s['best_val_loss']:.3f} "
              f"time={s['wall_s']:.0f}s  batch trajectory: "
              f"{hist['global_batch'][0]} -> {hist['global_batch'][-1]}")

    os.makedirs("experiments", exist_ok=True)
    tmp = CSV + ".tmp"
    with open(tmp, "w") as f:
        f.write("scheme,steps,avg_bsz,best_loss,best_val_loss,wall_s\n")
        for name, s in rows:
            f.write(f"{name},{s['steps']},{s['avg_batch']:.1f},"
                    f"{s['best_loss']:.4f},{s['best_val_loss']:.4f},"
                    f"{s['wall_s']:.1f}\n")
    os.replace(tmp, CSV)
    print(f"\nwrote {CSV}")
    return hists


if __name__ == "__main__":
    main()
