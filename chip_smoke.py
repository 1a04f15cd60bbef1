#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, on the card

Phases, one line each, and the first failure ends the run with a non-zero
exit (nothing is caught):

1. device   — the card's name and power limit (`nvidia-smi`).
2. build    — compiles every CUDA kernel of the port from
              src/repro_torch/kernels/csrc/*.cu (one nvcc each, all started
              together) and prints the build time, before any rank spawns.
3. check    — each kernel against its plain PyTorch version on the card:
              sizes 1, 17, 1 000 003 (ragged tail), 1 048 576 (one 4 MiB
              f32 bucket) and 32 768 000 (microllama's embedding leaf), f32,
              bf16 and mixed operands, AdamW clip on and off, the stats
              kernels also on unaligned views; tolerances printed and
              asserted.
4. ref      — two ACCUM-NORM steps of the microllama smoke config on the
              card (kernels) and on the CPU (plain versions) from the same
              parameters; the metrics must agree.
5. fsdp-ref — two FSDP-Norm steps of the same smoke config with 2 gloo
              ranks, flat/flat and tree/tree (`AdamWConfig(use_kernel=True)`),
              on the card and on the CPU; the metrics must agree.  In the
              tree run each rank also computes the statistic from its real
              g_j and g through the `sqdiff_norm` kernel and through the
              plain `tree_sqdiff`, which must agree.  This is the path of
              `fused_adamw` and `sqdiff_norm`: each rank's launch counts
              start at 0 and must be > 0 after it.
6. train    — slice 1's path: `run_training` of full-width microllama-300m
              (adaptive batch, ACCUM-NORM, flat stats and params) for 6
              steps; launch counts set to 0 just before and read just
              after must equal steps x buckets.
7. fsdp     — the main path: `run_training` of full-width microllama-300m
              with FSDP-Norm, flat stats and params, 2 workers on the one
              card (gloo), 6 steps; var_l1 must be finite and > 0 at every
              step, and each rank's `fused_stats` and `fused_adamw_stats`
              launches in the run must equal steps x buckets.  Then the
              step's collectives alone (every bucket's all-reduce and
              all-gather), timed on two fresh ranks.
8. time     — each kernel, its plain version and the nearest library call
              at the main path's shapes (all buckets of the layout), timed
              with CUDA events, beside the least time the card could take.

Then one JSON line describing the kernels, the nvidia-smi line, and the
final line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, it fails before printing any
result.
"""

import gc
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
# per element: fused AdamW reads p, g, m, v and writes p, m, v (~20 flops);
# the stats kernels read x and y (d = x - y, d*d, + and y*y, +: 5 flops;
# sqdiff_norm 3)
ADAMW_FLOPS_PER_ELEM = 20
STATS_FLOPS_PER_ELEM = 5
SQDIFF_FLOPS_PER_ELEM = 3

TRAIN_JOB = dict(arch="microllama-300m", smoke=False, schedule="adaptive",
                 step_impl="accum_norm", stats_impl="flat", params_impl="flat",
                 seq_len=512, base_global_batch=8, max_global_batch=32,
                 base_micro_batch=4, max_micro_batch=8, base_accum=2, steps=6,
                 eval_every=0, device="cuda")
# the main path: two FSDP-Norm workers share the one card through gloo
FSDP_JOB = dict(TRAIN_JOB, step_impl="fsdp_norm", mesh_data=2,
                dist_backend="gloo")
REF_RTOL = 1e-4          # card vs CPU step metrics (sums in another order)
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")


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


def close(a: float, b: float, rtol: float) -> bool:
    return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12)


def fsdp_ref_rank(cpu_params, batches):
    """One rank of phase 5: FSDP-Norm steps on the card and on the CPU from
    the same parameters, flat/flat and tree/tree.  Returns every rank's
    metrics, launch counts and statistic check (a list, one per rank)."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.norm_test import worker_variance_stats
    from repro_torch.distributed.sharding import shard_flat_buffers
    from repro_torch.distributed.train_step import (
        _accumulate, batch_to_device, make_fsdp_norm_step, worker_batch,
        worker_mean)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import num_workers, rank_device, worker_index
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    model = build_model(get_smoke_config("microllama-300m"))
    J, rank = num_workers(), worker_index()
    out = {}
    for impl in ("flat", "tree"):
        for d in ("cpu", "cuda"):
            dev = rank_device(d, rank)
            ops.reset_launch_counts()
            params = tree_map(lambda x: x.to(dev, copy=True), cpu_params)
            wrap = make_fsdp_norm_step(
                model, AdamWConfig(use_kernel=impl == "tree"), stats_impl=impl,
                params_impl=impl, params_like=params, device=dev)
            check = None
            if impl == "tree":
                # the statistic from this rank's real g_j and g (the step's
                # own helpers, the first step's inputs), through the
                # sqdiff_norm kernel and through the plain tree_sqdiff
                leaves, treedef = tree_flatten(params)
                g_j = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
                b = worker_batch(batch_to_device(batches[0], dev), rank, J)
                w_j = _accumulate(model.loss, params, b, False, g_j)[4]
                g = [torch.empty_like(x) for x in g_j]
                worker_mean(g_j, w_j, g)
                g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
                kern = worker_variance_stats(g_j, g, sqdiff_fn=ops.sqdiff_norm_tree)
                plain = worker_variance_stats(g_j, g)
                check = [float(kern[0]), float(plain[0])]
                if not close(*check, 1e-5):
                    raise AssertionError(f"sqdiff_norm_tree vs tree_sqdiff: {check}")
                opt = init_adamw(params)
            else:
                opt = init_adamw_flat(params, layout=wrap.flat_layout, device=dev)
                params = tuple(shard_flat_buffers(wrap.flat_layout.flatten(params)))
            mets = []
            for b in batches:
                params, opt, m = wrap(b)(params, opt, batch_to_device(b, dev), 1e-3)
                mets.append({k: float(m[k]) for k in METRICS})
            if check is not None and not close(check[0], mets[0]["var_l1"], REF_RTOL):
                raise AssertionError(f"statistic check {check} vs the step's "
                                     f"var_l1 {mets[0]['var_l1']}")
            out[f"{impl}/{d}"] = {"metrics": mets, "launches": ops.launch_counts(),
                                  "sqdiff_check": check,
                                  "buckets": (wrap.flat_layout.num_buffers
                                              if impl == "flat" else None),
                                  "leaves": len(tree_flatten(params)[0])}
    every = [None] * J
    dist.all_gather_object(every, out)
    return every


def collectives_rank(sizes, probe_n):
    """One rank of phase 7's collective timing: the FSDP-Norm step's
    collectives on the card through gloo — an all-reduce of every f32
    gradient bucket and an all-gather of every bucket's shards, timed on
    the host clock around work that ends in a sync; also one all-reduce
    and one all-gather of `probe_n` elements.  Returns every rank's
    seconds (a list, one per rank)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import gather_flat_buffers
    from repro_torch.launch.mesh import num_workers, psum, rank_device, worker_index

    J = num_workers()
    dev = rank_device("cuda", worker_index())
    grads = [torch.ones(n, device=dev) for n in sizes]
    shards = [torch.ones(n // J, device=dev) for n in sizes]
    full = [torch.empty(n, device=dev) for n in sizes]

    def timed(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    probe = [torch.ones(probe_n, device=dev), torch.empty(probe_n * J, device=dev)]
    out = {"all_reduce_s": timed(lambda: [psum(g) for g in grads]),
           "all_gather_s": timed(lambda: gather_flat_buffers(shards, full)),
           "probe_all_reduce_s": timed(lambda: psum(probe[0])),
           "probe_all_gather_s": timed(lambda: gather_flat_buffers(
               probe[:1], probe[1:]))}
    every = [None] * J
    dist.all_gather_object(every, out)
    return every


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
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_adamw import (
        adamw_scalars, fused_adamw, fused_adamw_stats)
    from repro_torch.kernels.fused_stats import fused_stats
    from repro_torch.kernels.sqdiff_norm import sqdiff_norm

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

    # 2. build, before any rank spawns ------------------------------------------
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
    sum_rtol = 1e-5
    say("check", tolerances={"p_f32": tol[torch.float32],
                             "p_bf16": tol[torch.bfloat16],
                             "m_v": tol[torch.float32], "sums_rtol": sum_rtol})
    f32, bf16 = torch.float32, torch.bfloat16
    sizes = (1, 17, 1_000_003, 1_048_576, 32_768_000)
    cases = [(n, pd, f32, clip) for n in sizes for pd in (f32, bf16)
             for clip in (1.0, 0.37)]
    cases.append((1_000_003, bf16, bf16, 0.37))
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
        torch.testing.assert_close(m, want[1], **tol[f32])
        torch.testing.assert_close(v, want[2], **tol[f32])
        torch.testing.assert_close(gsq, want[3], rtol=sum_rtol, atol=0.0)
        say("check", kernel="fused_adamw_stats", n=n, p=str(pd), g=str(gd), clip=clip,
            p_max_abs_err=float((p.float() - want[0].float()).abs().max()),
            m_max_abs_err=float((m - want[1]).abs().max()),
            v_max_abs_err=float((v - want[2]).abs().max()),
            gsq_rel_err=float(((gsq - want[3]) / want[3]).abs()))
        del p, g, m, v, want
    pairs = ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16))
    for n in (1, 17, 1_000_003):
        for pd, gd in pairs:
            p, g, m, v = adamw_inputs(n, pd, gd, n + 1, dev)
            sc = dict(lr=torch.tensor(3e-4, device=dev),
                      c1=torch.tensor(1 - 0.9 ** 3, device=dev),
                      c2=torch.tensor(1 - 0.95 ** 3, device=dev))
            want = ref.adamw_ref(p, g, m, v, **sc, **hyper)
            fused_adamw(p, g, m, v, adamw_scalars(*sc.values(), 1.0, dev), **hyper)
            torch.cuda.synchronize()
            torch.testing.assert_close(p, want[0], **tol[pd])
            torch.testing.assert_close(m, want[1], **tol[f32])
            torch.testing.assert_close(v, want[2], **tol[f32])
            say("check", kernel="fused_adamw", n=n, p=str(pd), g=str(gd),
                p_max_abs_err=float((p.float() - want[0].float()).abs().max()),
                m_max_abs_err=float((m - want[1]).abs().max()),
                v_max_abs_err=float((v - want[2]).abs().max()))
            del p, g, m, v, want
    for n in sizes:
        for (xd, yd), offset in [(pr, 0) for pr in pairs] + [((f32, f32), 1)]:
            gen = torch.Generator(device=dev).manual_seed(n + 7)
            x = (1e-3 * torch.randn(n + offset, device=dev, generator=gen)).to(xd)[offset:]
            y = (1e-3 * torch.randn(n + offset, device=dev, generator=gen)).to(yd)[offset:]
            d, q = fused_stats(x, y)
            sq = sqdiff_norm(x, y)
            torch.cuda.synchronize()
            wd, wq = ref.fused_stats_ref(x, y)
            ws = ref.sqdiff_norm_ref(x, y)
            for got, want in ((d, wd), (q, wq), (sq, ws)):
                torch.testing.assert_close(got, want, rtol=sum_rtol, atol=0.0)
            say("check", kernel="fused_stats+sqdiff_norm", n=n, x=str(xd), y=str(yd),
                offset=offset, dsq_rel_err=float(((d - wd) / wd).abs()),
                ysq_rel_err=float(((q - wq) / wq).abs()),
                sqdiff_rel_err=float(((sq - ws) / ws).abs()))
            del x, y

    # 4. the card's step against the CPU's on a small model -------------------
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
    from repro_torch.launch.mesh import spawn_workers
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
        params = tree_map(lambda x: x.to(d, copy=True), cpu_params)
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
    for a, b in zip(runs["cuda"], runs["cpu"]):
        for k in METRICS:
            if not close(a[k], b[k], REF_RTOL):
                raise AssertionError(f"card vs CPU step metric {k}: {a[k]} vs {b[k]}")
    say("ref", rtol=REF_RTOL, cuda=runs["cuda"], cpu=runs["cpu"])

    # 5. FSDP-Norm, card against CPU, 2 gloo ranks -----------------------------
    fplan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
    batches = [make_batch(src, t, fplan, 64) for t in range(2)]
    t0 = time.time()
    ranks = spawn_workers(fsdp_ref_rank, 2, cpu_params, batches, backend="gloo")
    for rank, out in enumerate(ranks):
        for impl in ("flat", "tree"):
            card, cpu = out[f"{impl}/cuda"], out[f"{impl}/cpu"]
            for a, b in zip(card["metrics"], cpu["metrics"]):
                for k in METRICS:
                    if not close(a[k], b[k], REF_RTOL):
                        raise AssertionError(f"rank {rank} {impl}: card vs CPU {k}: "
                                             f"{a[k]} vs {b[k]}")
            if any(cpu["launches"].values()):
                raise AssertionError(f"a CPU run launched a kernel: {cpu['launches']}")
        steps = len(batches)
        want = {"flat": {"fused_stats": steps * out["flat/cuda"]["buckets"],
                         "fused_adamw_stats": steps * out["flat/cuda"]["buckets"],
                         "fused_adamw": 0, "sqdiff_norm": 0},
                "tree": {"fused_adamw": steps * out["tree/cuda"]["leaves"],
                         "sqdiff_norm": out["tree/cuda"]["leaves"],
                         "fused_stats": 0, "fused_adamw_stats": 0}}
        for impl in ("flat", "tree"):
            if out[f"{impl}/cuda"]["launches"] != want[impl]:
                raise AssertionError(f"rank {rank} {impl} launches "
                                     f"{out[f'{impl}/cuda']['launches']}, expected "
                                     f"{want[impl]}")
    tree_launches = {k: sum(r["tree/cuda"]["launches"][k] for r in ranks)
                     for k in ("fused_adamw", "sqdiff_norm")}
    say("fsdp-ref", rtol=REF_RTOL, seconds=round(time.time() - t0, 3),
        metrics={k: v["metrics"] for k, v in ranks[0].items()},
        sqdiff_check=[r["tree/cuda"]["sqdiff_check"] for r in ranks],
        launches=[{k: v["launches"] for k, v in r.items() if k.endswith("cuda")}
                  for r in ranks])

    # 6. slice 1's path: ACCUM-NORM, full-width microllama-300m ----------------
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.launch.train import TrainJob, run_training

    def check_train(job, hist):
        losses = hist["loss"]
        if len(hist["step"]) != job["steps"] or not all(map(math.isfinite, losses)):
            raise AssertionError(f"training went wrong: {len(hist['step'])} steps, "
                                 f"losses {losses}")
        # random init (std 0.02) gives near-uniform logits: loss ≈ ln(vocab)
        if abs(losses[0] - math.log(32000)) > 0.5:
            raise AssertionError(f"first loss {losses[0]} is not near ln(32000)")
        step_s = [b - a for a, b in zip([0.0] + hist["time"][:-1], hist["time"])]
        tokens = [gb * job["seq_len"] for gb in hist["global_batch"]]
        return dict(global_batch=hist["global_batch"], loss=losses,
                    var_l1=hist["var_l1"], step_ms=[round(1e3 * t, 3) for t in step_s],
                    tokens_per_s_after_step1=sum(tokens[1:]) / sum(step_s[1:]),
                    engine=hist["engine"])

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    hist = run_training(TrainJob(**TRAIN_JOB))
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    layout = FlatLayout.from_tree(hist["final_params"], device=dev)
    expect = TRAIN_JOB["steps"] * layout.num_buffers
    if launches != {"fused_adamw_stats": expect, "fused_adamw": 0, "fused_stats": 0,
                    "sqdiff_norm": 0}:
        raise AssertionError(f"ACCUM-NORM launches {launches}, expected "
                             f"{expect} fused_adamw_stats and nothing else")
    say("train", nvidia_smi=smi, params=sum(layout.buffer_sizes),
        buckets=layout.num_buffers, launches=launches, peak_mem_bytes=peak,
        **check_train(TRAIN_JOB, hist))
    del hist
    gc.collect()
    torch.cuda.empty_cache()       # the ranks below need the card's memory

    # 7. the main path: FSDP-Norm, 2 workers on the one card --------------------
    ops.reset_launch_counts()
    hist = run_training(TrainJob(**FSDP_JOB))
    fsdp_layout = FlatLayout.from_tree(hist["final_params"], shard_divisor=2,
                                       device=dev)
    expect = FSDP_JOB["steps"] * fsdp_layout.num_buffers
    for rank, r in enumerate(hist["ranks"]):
        want = {"fused_stats": expect, "fused_adamw_stats": expect,
                "fused_adamw": 0, "sqdiff_norm": 0}
        if r["launches"] != want:
            raise AssertionError(f"rank {rank} launched {r['launches']}, expected "
                                 f"{want} ({FSDP_JOB['steps']} steps x "
                                 f"{fsdp_layout.num_buffers} buckets)")
    if not all(math.isfinite(x) and x > 0 for x in hist["var_l1"]):
        raise AssertionError(f"var_l1 must be finite and > 0: {hist['var_l1']}")
    if ops.launch_counts() != {k: 0 for k in launches}:
        raise AssertionError("the parent launched kernels during the ranks' run")
    fsdp_launches = {k: sum(r["launches"][k] for r in hist["ranks"])
                     for k in ("fused_stats", "fused_adamw_stats")}
    say("fsdp", nvidia_smi=smi, workers=hist["workers"], backend="gloo",
        buckets=fsdp_layout.num_buffers, ranks=hist["ranks"],
        **check_train(FSDP_JOB, hist))
    del hist
    gc.collect()
    # the step's collectives alone, at its bucket sizes
    coll = spawn_workers(collectives_rank, 2, fsdp_layout.buffer_sizes, 1 << 24,
                         backend="gloo")
    say("collectives", nvidia_smi=smi, backend="gloo", workers=2,
        bytes_all_reduce=4 * sum(fsdp_layout.buffer_sizes),
        bytes_all_gather=4 * sum(fsdp_layout.buffer_sizes), probe_elements=1 << 24,
        ranks=coll)

    # 8. timing at the main path's shapes --------------------------------------
    sizes = layout.buffer_sizes
    n_total = sum(sizes)
    bufs = [adamw_inputs(n, f32, f32, i, dev) for i, n in enumerate(sizes)]
    scal = adamw_scalars(torch.tensor(3e-4, device=dev), torch.tensor(0.271, device=dev),
                         torch.tensor(0.142625, device=dev), torch.tensor(0.5, device=dev), dev)
    ref_kw = dict(lr=scal[0], c1=scal[1], c2=scal[2], **hyper)
    # each kernel against its plain version over the whole layout, on copies
    err = {k: 0.0 for k in ("fused_adamw_stats", "fused_adamw", "fused_stats",
                            "sqdiff_norm")}
    for p, g, m, v in bufs:
        for kernel, plain in ((fused_adamw_stats, ref.adamw_stats_ref),
                              (fused_adamw, ref.adamw_ref)):
            p2, m2, v2 = p.clone(), m.clone(), v.clone()
            stats = kernel is fused_adamw_stats
            want = plain(p, g, m, v, **ref_kw, **({"clip_scale": scal[3]} if stats else {}))
            kernel(p2, g, m2, v2, scal, **hyper)
            for got, w in zip((p2, m2, v2), want):
                torch.testing.assert_close(got, w, **tol[f32])
                err[kernel.__name__] = max(err[kernel.__name__],
                                           float((got - w).abs().max()))
            del p2, m2, v2, want
        # the statistics inputs: g_j (here m) and g (here g), f32 buckets
        for got, want, k in ((fused_stats(m, g), ref.fused_stats_ref(m, g), "fused_stats"),
                             ((sqdiff_norm(m, g),), (ref.sqdiff_norm_ref(m, g),),
                              "sqdiff_norm")):
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=sum_rtol, atol=0.0)
                err[k] = max(err[k], float((a - b).abs()))

    over_layout = lambda fn: (lambda: [fn(*b) for b in bufs])
    tails = {
        "fused_adamw_stats": (over_layout(lambda p, g, m, v: fused_adamw_stats(
                                  p, g, m, v, scal, **hyper)),
                              over_layout(lambda p, g, m, v: ref.adamw_stats_ref(
                                  p, g, m, v, clip_scale=scal[3], **ref_kw))),
        "fused_adamw": (over_layout(lambda p, g, m, v: fused_adamw(
                            p, g, m, v, scal, **hyper)),
                        over_layout(lambda p, g, m, v: ref.adamw_ref(
                            p, g, m, v, **ref_kw))),
        "fused_stats": (over_layout(lambda p, g, m, v: fused_stats(m, g)),
                        over_layout(lambda p, g, m, v: ref.fused_stats_ref(m, g))),
        "sqdiff_norm": (over_layout(lambda p, g, m, v: sqdiff_norm(m, g)),
                        over_layout(lambda p, g, m, v: ref.sqdiff_norm_ref(m, g))),
    }
    lib_params = [torch.nn.Parameter(p) for p, _, _, _ in bufs]
    for lp, (_, g, _, _) in zip(lib_params, bufs):
        lp.grad = g
    lib_opt = torch.optim.AdamW(lib_params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
    library = {
        "fused_adamw_stats": lib_opt.step, "fused_adamw": lib_opt.step,
        # two calls a bucket: ‖x − y‖ and ‖y‖
        "fused_stats": over_layout(lambda p, g, m, v: (
            torch.dist(m, g), torch.linalg.vector_norm(g))),
        "sqdiff_norm": over_layout(lambda p, g, m, v: torch.dist(m, g)),
    }
    per_elem = {"fused_adamw_stats": (28, ADAMW_FLOPS_PER_ELEM),
                "fused_adamw": (28, ADAMW_FLOPS_PER_ELEM),
                "fused_stats": (8, STATS_FLOPS_PER_ELEM),
                "sqdiff_norm": (8, SQDIFF_FLOPS_PER_ELEM)}
    timed = {}
    for k, (kernel_tail, plain_tail) in tails.items():
        nbytes, flops = per_elem[k]
        bound_bytes = nbytes * n_total / bw * 1e3
        bound_ops = flops * n_total / F32_FLOPS * 1e3
        timed[k] = {"ms": [cuda_ms(kernel_tail, 5), cuda_ms(kernel_tail, 5)],
                    "plain_ms": [cuda_ms(plain_tail, 3), cuda_ms(plain_tail, 3)],
                    "library_ms": [cuda_ms(library[k], 5), cuda_ms(library[k], 5)],
                    "bound_bytes_ms": bound_bytes, "bound_ops_ms": bound_ops}
    # the FSDP path's AdamW tail: one rank's 1/2 shard of every bucket
    shards = [tuple(x[:x.numel() // 2] for x in b) for b in bufs]
    sharded_ms = cuda_ms(lambda: [fused_adamw_stats(p, g, m, v, scal, **hyper)
                                  for p, g, m, v in shards], 5)
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    p, g, m, v = bufs[big]
    big_opt = torch.optim.AdamW([lib_params[big]], lr=3e-4, betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
    t_big = {
        "fused_adamw_stats_ms": cuda_ms(lambda: fused_adamw_stats(p, g, m, v, scal, **hyper), 20),
        "fused_adamw_ms": cuda_ms(lambda: fused_adamw(p, g, m, v, scal, **hyper), 20),
        "fused_stats_ms": cuda_ms(lambda: fused_stats(m, g), 20),
        "sqdiff_norm_ms": cuda_ms(lambda: sqdiff_norm(m, g), 20),
        "adamw_plain_ms": cuda_ms(lambda: ref.adamw_stats_ref(
            p, g, m, v, clip_scale=scal[3], **ref_kw), 10),
        "adamw_library_ms": cuda_ms(big_opt.step, 20),
        "adamw_bound_ms": 28 * sizes[big] / bw * 1e3,
        "stats_bound_ms": 8 * sizes[big] / bw * 1e3, "elements": sizes[big]}
    say("time", nvidia_smi=smi, elements=n_total, buckets=len(sizes), kernels=timed,
        sharded_fused_adamw_stats={"ms": sharded_ms,
                                   "elements": sum(x[0].numel() for x in shards),
                                   "bound_ms": 28 * n_total / 2 / bw * 1e3},
        largest_bucket=t_big, max_abs_err=err)

    sources = {"fused_adamw_stats": "fused_adamw.cu", "fused_adamw": "fused_adamw.cu",
               "fused_stats": "fused_stats.cu", "sqdiff_norm": "fused_stats.cu"}
    replaces = {"fused_adamw_stats": "src/repro/kernels/fused_adamw.py:107",
                "fused_adamw": "src/repro/kernels/fused_adamw.py:77",
                "fused_stats": "src/repro/kernels/fused_stats.py:35",
                "sqdiff_norm": "src/repro/kernels/sqdiff_norm.py:29"}
    # launches: the FSDP main path's run (both ranks) for the flat kernels,
    # the tree run of phase 5 (both ranks, on the card) for the others
    path_launches = {**fsdp_launches, **tree_launches}
    entries = []
    for k, t in timed.items():
        bound = max(t["bound_bytes_ms"], t["bound_ops_ms"])
        entries.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[k]}",
            "replaces": replaces[k], "launches": path_launches[k],
            "max_abs_err": err[k], "ms": min(t["ms"]), "plain_ms": min(t["plain_ms"]),
            "bound_ms": bound,
            "bound_by": "bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"] else "operations",
            "library_ms": min(t["library_ms"])})
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
