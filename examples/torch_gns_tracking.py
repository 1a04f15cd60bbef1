"""Critical-batch-size tracking through the port: the norm test as a
thresholded gradient-noise-scale controller (paper §5.4's conjecture,
empirically; counterpart of `examples/gns_tracking.py`).

Runs an adaptive job, tracks McCandlish's B_simple from the SAME statistics
the norm test computes, and shows the batch trajectory hugging
B_simple/eta^2 until the max-batch clamp.

    PYTHONPATH=src python examples/torch_gns_tracking.py [--steps 50] [--device cpu]

Runs on the CUDA card unless `--device cpu`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.gns import GNSTracker, gns_from_norm_test, variance_groups  # noqa: E402
from repro_torch.launch.train import TrainJob, run_training  # noqa: E402

ETA = 0.15
# the reference example's job, less its step count
JOB = dict(arch="llama3.2-1b", schedule="adaptive", eta=ETA,
           step_impl="accum_norm", seq_len=64,
           base_global_batch=4, max_global_batch=256,
           base_micro_batch=2, max_micro_batch=4, base_accum=2,
           eval_every=0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--device", default="", choices=("", "cuda", "cpu"),
                        help="the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)
    job = TrainJob(**JOB, steps=args.steps, device=args.device)
    hist = run_training(job)

    workers = hist["workers"]
    tracker = GNSTracker(alpha=0.8)
    print(f"{'step':>5} {'batch':>6} {'T_k':>9} {'B_simple':>10} {'B/eta^2':>10}")
    for i, step in enumerate(hist["step"]):
        b = hist["global_batch"][i]
        # var_l1 arrives on the J scale for both step impls; the GROUP count
        # for the two-scale estimator comes from the recorded per-step plan
        # (M·J groups for ACCUM-NORM), not a hardcoded constant
        groups = variance_groups(job.step_impl, workers,
                                 hist["accum_steps"][i])
        est = gns_from_norm_test(hist["var_l1"][i], hist["grad_sqnorm"][i], b,
                                 workers)
        tracker = tracker.update(hist["var_l1"][i], hist["grad_sqnorm"][i], b,
                                 workers, groups=groups)
        if i % 5 == 0:
            print(f"{step:>5} {b:>6} {hist['T'][i]:>9.1f} "
                  f"{est['b_simple']:>10.1f} {est['b_simple']/ETA**2:>10.1f}")
    print("\nAlgorithm 1 grows b_k toward T_k = B-related quantity / eta^2;"
          "\nthe trajectory saturates once b_k exceeds the noise scale.")
    hist["tracker"] = tracker
    return hist


if __name__ == "__main__":
    main()
