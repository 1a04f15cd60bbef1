"""Batched serving through the port: KV-cache decode with the serve step
(counterpart of `examples/serve_batched.py`).

    PYTHONPATH=src python examples/torch_serve_batched.py --arch gemma2-27b [--device cpu]

Runs on the CUDA card (the decode step replayed as a CUDA graph) unless
`--device cpu`.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.serve import run_serving  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="gemma2-27b")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)

    res = run_serving(args.arch, smoke=True, batch=args.batch, prompt_len=24,
                      gen_len=24, device=args.device)
    print(f"arch={args.arch} batch={args.batch}")
    print(f"prefill {res['prefill_s']:.2f}s | decode {res['decode_s']:.2f}s "
          f"({res['decode_tok_per_s']:.1f} tok/s)")
    for i, row in enumerate(res["tokens"][:2]):
        print(f"request {i}: {row[:12].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
