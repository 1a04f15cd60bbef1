#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, on the card

Phases, one line each, and the first failure ends the run with a non-zero
exit (nothing is caught):

1. device  — the card's name and power limit (`nvidia-smi`).
2. build   — compiles every CUDA kernel of the port from
             src/repro_torch/kernels/csrc/*.cu (one nvcc each, all started
             together) and prints the build time.
3. check   — each kernel against its plain PyTorch version on the card:
             sizes 1, 17, 1 000 003 (ragged tail), 1 048 576 (one 4 MiB f32
             bucket) and 32 768 000 (microllama's embedding leaf), p f32 and
             bf16, clip on and off, tolerances printed and asserted.
4. ref     — two ACCUM-NORM steps of the microllama smoke config on the card
             (kernel) and on the CPU (plain version) from the same
             parameters; the metrics must agree.
5. train   — the main path: `run_training` of full-width microllama-300m
             (adaptive batch, ACCUM-NORM, flat stats and params) for 6 steps
             on the card; every kernel's launch count is set to 0 just
             before and read just after, and must equal steps x buckets.
6. time    — each kernel, its plain version and the nearest library call
             at the main path's shapes (all buckets of the layout), timed
             with CUDA events, beside the least time the card could take.

Then one JSON line describing the kernels, the nvidia-smi line, and the
final line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, it fails before printing any
result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# Published peaks (NVIDIA data sheets): device memory bandwidth by part,
# and dense float32 outside the tensor cores (H100 SXM; the PCIe part is
# lower, which only makes the byte bound the larger one still).
MEM_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
          "H200": 4.8e12}
F32_FLOPS = 67e12
# fused AdamW per element: read p, g, m, v; write p, m, v
ADAMW_FLOPS_PER_ELEM = 20

TRAIN_JOB = dict(arch="microllama-300m", smoke=False, schedule="adaptive",
                 step_impl="accum_norm", stats_impl="flat", params_impl="flat",
                 seq_len=512, base_global_batch=8, max_global_batch=32,
                 base_micro_batch=4, max_micro_batch=8, base_accum=2, steps=6,
                 eval_every=0, device="cuda")


def say(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def mem_bw(name: str) -> float:
    for part in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if part in name:
            return MEM_BW[part]
    raise RuntimeError(f"no published memory bandwidth for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def adamw_inputs(n, p_dtype, g_dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = (0.02 * torch.randn(n, device=dev, generator=gen)).to(p_dtype)
    g = (1e-3 * torch.randn(n, device=dev, generator=gen)).to(g_dtype)
    m = 1e-4 * torch.randn(n, device=dev, generator=gen)
    v = 1e-6 * torch.rand(n, device=dev, generator=gen)
    return p, g, m, v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adamw import adamw_scalars, fused_adamw_stats

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = mem_bw(name)
    say("device", nvidia_smi=smi, torch_name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, mem_bw_bytes_s=bw)

    # 2. build ----------------------------------------------------------------
    sources = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    t0 = time.time()
    logs = kernels.build_all(sources)
    say("build", sources=sources, seconds=round(time.time() - t0, 3),
        ptxas=[line.strip() for log in logs.values() for line in log.splitlines()
               if "registers" in line or "spill" in line])

    # 3. kernel vs plain version on the card ---------------------------------
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    tol = {torch.float32: dict(rtol=1e-6, atol=1e-9),
           torch.bfloat16: dict(rtol=2 ** -8, atol=1e-9)}
    gsq_rtol = 1e-5
    say("check", tolerances={"p_f32": tol[torch.float32],
                             "p_bf16": tol[torch.bfloat16],
                             "m_v": tol[torch.float32], "gsq_rtol": gsq_rtol})
    cases = [(n, pd, torch.float32, clip)
             for n in (1, 17, 1_000_003, 1_048_576, 32_768_000)
             for pd in (torch.float32, torch.bfloat16) for clip in (1.0, 0.37)]
    cases.append((1_000_003, torch.bfloat16, torch.bfloat16, 0.37))
    for n, pd, gd, clip in cases:
        p, g, m, v = adamw_inputs(n, pd, gd, n, dev)
        sc = dict(lr=torch.tensor(3e-4, device=dev),
                  c1=torch.tensor(1 - 0.9 ** 3, device=dev),
                  c2=torch.tensor(1 - 0.95 ** 3, device=dev),
                  clip_scale=torch.tensor(clip, device=dev))
        want = ref.adamw_stats_ref(p, g, m, v, **sc, **hyper)
        gsq = fused_adamw_stats(p, g, m, v, adamw_scalars(*sc.values(), dev), **hyper)
        torch.cuda.synchronize()
        torch.testing.assert_close(p, want[0], **tol[pd])
        torch.testing.assert_close(m, want[1], **tol[torch.float32])
        torch.testing.assert_close(v, want[2], **tol[torch.float32])
        torch.testing.assert_close(gsq, want[3], rtol=gsq_rtol, atol=0.0)
        say("check", n=n, p=str(pd), g=str(gd), clip=clip,
            p_max_abs_err=float((p.float() - want[0].float()).abs().max()),
            m_max_abs_err=float((m - want[1]).abs().max()),
            v_max_abs_err=float((v - want[2]).abs().max()),
            gsq_rel_err=float(((gsq - want[3]) / want[3]).abs()))
        del p, g, m, v, want

    # 4. the card's step against the CPU's on a small model -------------------
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat
    from repro_torch.tree import tree_map

    cfg = get_smoke_config("microllama-300m")
    model = build_model(cfg)
    cpu_params = model.init(0, "cpu")
    plan = BatchPlan(global_batch=8, micro_batch=4, accum_steps=2, workers=1)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    runs = {}
    for d in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(d), cpu_params)
        wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl="flat",
                                    params_impl="flat", params_like=params,
                                    device=d)
        opt = init_adamw_flat(params, layout=wrap.flat_layout, device=d)
        pb = tuple(wrap.flat_layout.flatten(params))
        out = []
        for t in range(2):
            b = make_batch(src, t, plan, 64)
            pb, opt, met = wrap(b)(pb, opt, batch_to_device(b, d), 1e-3)
            out.append({k: float(x) for k, x in met.items()})
        runs[d] = out
    ref_rtol = 1e-4
    for a, b in zip(runs["cuda"], runs["cpu"]):
        for k in ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale"):
            if not math.isclose(a[k], b[k], rel_tol=ref_rtol, abs_tol=1e-12):
                raise AssertionError(f"card vs CPU step metric {k}: {a[k]} vs {b[k]}")
    say("ref", rtol=ref_rtol, cuda=runs["cuda"], cpu=runs["cpu"])

    # 5. the main path: full-width microllama-300m on the card ---------------
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.launch.train import TrainJob, run_training

    torch.cuda.reset_peak_memory_stats()
    fused_adamw_stats.launches = 0
    hist = run_training(TrainJob(**TRAIN_JOB))
    launches = {"fused_adamw_stats": fused_adamw_stats.launches}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    layout = FlatLayout.from_tree(hist["final_params"], device=dev)
    steps = len(hist["step"])
    expect = steps * layout.num_buffers
    losses = hist["loss"]
    if steps != TRAIN_JOB["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training went wrong: {steps} steps, losses {losses}")
    # random init (std 0.02) gives near-uniform logits: loss ≈ ln(vocab)
    if abs(losses[0] - math.log(32000)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near ln(32000)")
    if launches["fused_adamw_stats"] != expect:
        raise AssertionError(f"fused_adamw_stats launched {launches} times, "
                             f"expected {steps} steps x {layout.num_buffers} buckets")
    step_s = [b - a for a, b in zip([0.0] + hist["time"][:-1], hist["time"])]
    tokens = [gb * TRAIN_JOB["seq_len"] for gb in hist["global_batch"]]
    say("train", nvidia_smi=smi, params=sum(layout.buffer_sizes),
        buckets=layout.num_buffers, launches=launches, global_batch=hist["global_batch"],
        loss=losses, step_ms=[round(1e3 * s, 3) for s in step_s],
        tokens_per_s_after_step1=sum(tokens[1:]) / sum(step_s[1:]),
        peak_mem_bytes=peak, engine=hist["engine"])
    del hist

    # 6. timing at the main path's shapes --------------------------------------
    sizes = layout.buffer_sizes
    n_total = sum(sizes)
    bufs = [adamw_inputs(n, torch.float32, torch.float32, i, dev)
            for i, n in enumerate(sizes)]
    scal = adamw_scalars(torch.tensor(3e-4, device=dev), torch.tensor(0.271, device=dev),
                         torch.tensor(0.142625, device=dev), torch.tensor(0.5, device=dev), dev)
    # the kernel against its plain version over the whole layout, on copies
    err = 0.0
    for p, g, m, v in bufs:
        p2, m2, v2 = p.clone(), m.clone(), v.clone()
        want = ref.adamw_stats_ref(p, g, m, v, lr=scal[0], c1=scal[1], c2=scal[2],
                                   clip_scale=scal[3], **hyper)
        fused_adamw_stats(p2, g, m2, v2, scal, **hyper)
        for got, w in zip((p2, m2, v2), want):
            torch.testing.assert_close(got, w, **tol[torch.float32])
            err = max(err, float((got - w).abs().max()))
        del p2, m2, v2, want

    def kernel_tail():
        for p, g, m, v in bufs:
            fused_adamw_stats(p, g, m, v, scal, **hyper)

    def plain_tail():
        for p, g, m, v in bufs:
            ref.adamw_stats_ref(p, g, m, v, lr=scal[0], c1=scal[1], c2=scal[2],
                                clip_scale=scal[3], **hyper)

    lib_params = [torch.nn.Parameter(p) for p, _, _, _ in bufs]
    for lp, (_, g, _, _) in zip(lib_params, bufs):
        lp.grad = g
    lib_opt = torch.optim.AdamW(lib_params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)

    big = max(range(len(sizes)), key=lambda i: sizes[i])
    p, g, m, v = bufs[big]
    big_opt = torch.optim.AdamW([lib_params[big]], lr=3e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
    t_big = {
        "kernel_ms": cuda_ms(lambda: fused_adamw_stats(p, g, m, v, scal, **hyper), 20),
        "plain_ms": cuda_ms(lambda: ref.adamw_stats_ref(
            p, g, m, v, lr=scal[0], c1=scal[1], c2=scal[2], clip_scale=scal[3],
            **hyper), 10),
        "library_ms": cuda_ms(big_opt.step, 20),
        "bound_ms": 28 * sizes[big] / bw * 1e3, "elements": sizes[big]}
    t_one = [cuda_ms(kernel_tail, 5), cuda_ms(kernel_tail, 5)]
    t_plain = [cuda_ms(plain_tail, 3), cuda_ms(plain_tail, 3)]
    t_lib = [cuda_ms(lib_opt.step, 5), cuda_ms(lib_opt.step, 5)]
    bytes_moved = 28 * n_total
    bound_bytes = bytes_moved / bw * 1e3
    bound_ops = ADAMW_FLOPS_PER_ELEM * n_total / F32_FLOPS * 1e3
    say("time", nvidia_smi=smi, elements=n_total, buckets=len(sizes),
        kernel_ms=t_one, plain_ms=t_plain, library_ms=t_lib,
        largest_bucket=t_big,
        bound_bytes_ms=bound_bytes, bound_ops_ms=bound_ops, max_abs_err=err)

    print(json.dumps({"kernels": [{
        "name": "fused_adamw_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_adamw.cu",
        "replaces": "src/repro/kernels/fused_adamw.py:107",
        "launches": launches["fused_adamw_stats"], "max_abs_err": err,
        "ms": min(t_one), "plain_ms": min(t_plain),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": min(t_lib)}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
