"""Quickstart through the port: pretrain a tiny Llama with the adaptive
batch-size schedule (counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60] [--device cpu]

Watch the `bsz` column: the norm test (Algorithm 1) grows the global batch
as training progresses — small batches early (cheap, high gradient noise
tolerated), large batches late (efficient, noise must shrink).  Runs on
the CUDA card unless `--device cpu`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.train import TrainJob, run_training, summarize  # noqa: E402

# the reference example's job, less its step count
JOB = dict(
    arch="llama3.2-1b",          # smoke-sized variant of the config
    smoke=True,
    schedule="adaptive",          # the paper's contribution
    eta=0.12,                     # gradient-noise tolerance (paper: 0.05-0.3)
    step_impl="accum_norm",       # single-device friendly estimator
    seq_len=64,
    base_global_batch=4, max_global_batch=64,
    base_micro_batch=2, max_micro_batch=4, base_accum=2,
    eval_every=20,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--device", default="", choices=("", "cuda", "cpu"),
                        help="the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)
    hist = run_training(TrainJob(**JOB, steps=args.steps, device=args.device))

    print(f"{'step':>5} {'bsz':>5} {'loss':>8} {'T_k':>8}")
    for i in range(0, len(hist["step"]), 5):
        print(f"{hist['step'][i]:>5} {hist['global_batch'][i]:>5} "
              f"{hist['loss'][i]:>8.4f} {hist['T'][i]:>8.1f}")
    print("\nsummary:", summarize(hist))
    return hist


if __name__ == "__main__":
    main()
