"""End-to-end driver through the port: pretrain a ~20M-parameter
Llama-family model with the adaptive batch schedule, eval and
checkpointing — the full production path (data pipeline -> step ->
controller -> checkpoint); counterpart of `examples/pretrain_e2e.py`.
With --full the same driver pretrains microllama-300m exactly as in the
paper, on the card's flat-resident path (stats and params in bucket
buffers: the fused AdamW tail, one launch a step per dtype group); the
~20M job keeps the reference example's tree residencies.

    PYTHONPATH=src python examples/torch_pretrain_e2e.py [--steps 150] [--full] [--device cpu]

Runs on the CUDA card unless `--device cpu`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import microllama_300m  # noqa: E402
from repro_torch.launch.train import TrainJob, run_training, summarize  # noqa: E402

E2E_ARCH = "microllama-20m"
# the reference example's job, less its arch, size and step count
JOB = dict(
    schedule="adaptive", step_impl="accum_norm", seq_len=128,
    base_global_batch=8, max_global_batch=64, base_micro_batch=2,
    max_micro_batch=8, base_accum=2, eval_every=50, eval_batches=4,
    checkpoint_dir="experiments/e2e_ckpt", log_path="experiments/e2e_log.csv",
    peak_lr=6e-4, warmup_frac=0.02,
)


def register_e2e_config():
    """Register the ~20M-param member of the family (4 layers, d=512) as
    `microllama-20m` in the port's config registry."""
    import repro_torch.configs as C
    cfg = microllama_300m.CONFIG.replace(
        name=E2E_ARCH, num_layers=4, d_model=512, num_heads=8,
        num_kv_heads=8, head_dim=64, d_ff=1408, vocab_size=8192)
    mod = type(sys)("repro_torch.configs._e2e")
    mod.CONFIG = cfg
    mod.smoke_config = lambda: cfg
    C._REGISTRY[E2E_ARCH] = "_e2e"
    sys.modules["repro_torch.configs._e2e"] = mod
    return cfg


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--full", action="store_true",
                        help="use the real 300M config (meant for the card)")
    parser.add_argument("--eta", type=float, default=0.15)
    parser.add_argument("--device", default="", choices=("", "cuda", "cpu"),
                        help="the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)

    if not args.full:
        register_e2e_config()
        arch, smoke, impls = E2E_ARCH, False, {}
    else:
        arch, smoke = "microllama-300m", False
        impls = dict(stats_impl="flat", params_impl="flat")

    job = TrainJob(arch=arch, smoke=smoke, eta=args.eta, steps=args.steps,
                   device=args.device, **JOB, **impls)
    os.makedirs(os.path.dirname(job.log_path), exist_ok=True)
    hist = run_training(job)
    s = summarize(hist)
    print("final:", s)
    print(f"batch grew {hist['global_batch'][0]} -> {hist['global_batch'][-1]}; "
          f"checkpoint at {job.checkpoint_dir}, log at {job.log_path}")
    assert hist["loss"][-1] < hist["loss"][0]
    return hist


if __name__ == "__main__":
    main()
