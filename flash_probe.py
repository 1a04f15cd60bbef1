#!/usr/bin/env python3
"""Time `flash_attention` and prefill of full-width llama3.2-1b on one card,
for one or more checkouts of this repository in turns.

    python3 flash_probe.py [TREE ...]     # default: this checkout

Each TREE is the root of a checkout (for instance a parent commit unpacked
with `git archive` into a git-ignored directory).  Each is run in a fresh
process that imports that tree's `src/repro_torch`, builds its kernels and
prints one JSON line: the card (`nvidia-smi` name and power limit), the
flash kernel at prefill's shapes (b 4, t 2048, 32 q / 8 kv heads, d 64,
causal; f32 and bf16; CUDA events, the mean of 5 calls, 3 timings each) with
its max abs error against the plain version, and prefill of 4 x 2048 tokens
through all 16 layers (host clock around a synchronised call; 3 runs after
a 64-token warm-up).  Trees listed in turns (A B B A) compare on one card.
Needs a CUDA card; fails without one.
"""

import json
import subprocess
import sys
from pathlib import Path


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import time

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import make_prefill
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import build_model

    if not torch.cuda.is_available():
        raise RuntimeError("flash_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def cuda_ms(fn, iters):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = {"tree": str(tree)}
    gen = torch.Generator(device=dev).manual_seed(11)
    b, t, h, kvh, d = 4, 2048, 32, 8, 64
    q = torch.randn(b, t, h, d, device=dev, generator=gen)
    k = torch.randn(b, t, kvh, d, device=dev, generator=gen)
    v = torch.randn(b, t, kvh, d, device=dev, generator=gen)
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            qq, kk, vv = (x.to(dt) for x in (q, k, v))
            got = flash_attention(qq, kk, vv, causal=True)
            want = ref.flash_attention_ref(qq, kk, vv, causal=True)
            out[f"flash_{str(dt)[6:]}"] = {
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "ms": [cuda_ms(lambda: flash_attention(qq, kk, vv, causal=True), 5)
                       for _ in range(3)]}
            del got, want
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(0, dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), device=dev, generator=gen)
    prefill = make_prefill(model)
    prefill(params, {"tokens": tokens[:, :64]})
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    out["prefill_ms"] = ms
    return out


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
