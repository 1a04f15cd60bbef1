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
              asserted.  Then the list entry points of the redesigned
              kernels (`fused_adamw_stats_buckets`, `fused_stats_buckets`)
              against the plain versions bucket by bucket: ragged sizes
              (1, 17, 2048, 1 000 003, 5 767 168, ...) with an unaligned
              entry and three dtype groups in one call, and rank 1's shard
              views of microllama's J = 2 layout; each case twice, the
              sums (and p, m, v) bit-identical, one launch per dtype group.
   serve-check — rmsnorm and flash_attention against their plain
              versions on the card: rmsnorm over rows {1, 7, 4096, 16384} x
              d {64, 100, 2048, 2050, 8192} x (f32/f32, bf16/bf16,
              bf16/f32) and unaligned views; flash over t != s, tails that
              are not a multiple of 64, GQA groups 1, 4, 8, head dims 16,
              32, 33 (4-byte copies; bf16 plain loads), 64, 100
              (openllama-3b's), 128, causal or not, window 0/100, softcap
              0/30, f32 and bf16; tolerances printed and asserted.  Then every dense config the port supports, at
              full width and 1 layer: the forward with grad mode off
              (training's eval loss; 1 flash and 3 rmsnorm launches)
              against the plain forward, and prefill against streamed
              decode.
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
   serve-ref — llama3.2-1b at full width and 2 layers, the same
              parameters on the card and on the CPU: prefill's last-token
              logits and caches, 8 `decode_step`s at per-row positions
              (logits and caches), and `run_serving`'s greedy tokens
              (batch 2, prompt 16, gen 8) must agree.
6. train    — slice 1's path: `run_training` of full-width microllama-300m
              (adaptive batch, ACCUM-NORM, flat stats and params) for 6
              steps; launch counts set to 0 just before and read just
              after must equal steps x dtype groups (one launch a step).
7. fsdp     — the main path: `run_training` of full-width microllama-300m
              with FSDP-Norm, flat stats and params, 2 workers on the one
              card (gloo), 6 steps; var_l1 must be finite and > 0 at every
              step, and each rank's `fused_stats` and `fused_adamw_stats`
              launches in the run must equal steps x dtype groups.  Then the
              step's collectives alone (every bucket's all-reduce and
              all-gather), timed on two fresh ranks.
   serve    — serving's main path, full-width llama3.2-1b (16 layers):
              `make_prefill` at 4 x 2048 tokens (launch counts 0 just
              before, exactly 16 flash_attention and 33 rmsnorm just after;
              its last-token logits and caches held against the same tokens
              streamed through `decode_step`), `run_serving` (batch 8,
              prompt 128, gen 64) and `run_continuous_serving` (8 slots,
              prompt 16, gen 32, 60 load steps, arrivals 0.5/step and a
              burst of 5 every 20), each with its own launch counts; the
              continuous run's figures for its load window alone beside
              the reference's keys, which also count the probe.
8. time     — each kernel, its plain version and the nearest library call
              at the main path's shapes (all buckets of the layout; for
              rmsnorm and flash_attention prefill's shapes), timed with
              CUDA events, beside the least time the card could take;
              `fused_adamw_stats` and `fused_stats` as one list call and in
              the earlier pattern of one call a bucket, in turns with the
              library call; the list calls, rmsnorm and flash_attention
              also held against their plain versions there; flash_attention
              also beside its split-TF32 tensor-core bound, and on bf16
              copies beside SDPA on the same copies.  Then the
              step's tail (`worker_variance_stats_buffers` and the sharded
              AdamW update) in both calling patterns, host clock, at J = 1
              and on the J = 2 shards.
9. the training surface beyond the main path:
   estimators — eq. 3 (`per_sample_norm_test`, per-sample gradients by
              vmap) and eq. 4 (`exact_variance_test_holds`) on the
              microllama smoke config, b = 8, the card against the CPU
              (rtol 1e-5; booleans equal).
   mixed    — the four residency combinations of both steps on the card,
              microllama-300m at full width and 2 layers (ACCUM-NORM in
              this process, FSDP-Norm on 2 gloo ranks), 2 steps each, held
              against the card's tree/tree step (metrics rtol 1e-5, params
              rtol and atol 1e-5).
   local-sgd — one flat-resident local-SGD round (H = 2, flat stats) on 2
              gloo ranks, the card against the CPU (metrics at the
              card-vs-CPU tolerance); per rank one `fused_stats` launch a
              round and one `fused_adamw_stats` a local step per dtype
              group.
   resume-accum — full-width, full-depth microllama-300m, ACCUM-NORM,
              flat stats and params: an uninterrupted 6-step run; the same
              job through `python -m repro_torch.launch.train` with a
              checkpoint every 2 steps, killed by the fault harness
              (SIGKILL) at the top of step 5; `run_training(resume=True)`
              to step 6.  Losses, batches, var_l1, eval losses and the
              step-6 checkpoints (params, moments, count, controller state)
              must be bit-identical; the resumed path's launch counts (one
              `fused_adamw_stats` a step per dtype group; one eval's flash
              and rmsnorm) are asserted; free space, checkpoint bytes and
              the save and restore times are printed, and the checkpoint
              directory is removed, passed or failed.
   resume-fsdp — the same with FSDP-Norm on 2 gloo ranks sharing the card
              (full depth): 6 steps; 4 steps with checkpoints, then a fresh
              `run_training(resume=True)` to 6, in one process group; the
              flat shards are gathered on save and re-split on resume.

Every process the run started (nvcc, the ranks and the resource tracker
that spawning them starts) must have ended by then; a child still there
fails the run.  Then one JSON line describing the kernels, the nvidia-smi
line, and the final line {"ok": true, "device": {...}}.  Without a CUDA device, or
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
# dense TF32 on the tensor cores (H100 SXM): flash_attention's f32 products
# run as three TF32 products each (split TF32)
TF32_FLOPS = 495e12
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
# serving: llama3.2-1b, the default arch of the reference's serve launcher
SERVE_ARCH = "llama3.2-1b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SERVE_JOB = dict(batch=8, prompt_len=128, gen_len=64)
CONT_JOB = dict(max_slots=8, prompt_len=16, gen_len=32, load_steps=60,
                arrival_rate=0.5, burst_every=20, burst_size=5)
# kernel vs plain version on the card: f32 sums in another order (flash
# also exp and the online rescaling), bf16 one rounding of the output
SERVE_TOL = {"rmsnorm_f32": dict(rtol=1e-5, atol=1e-5),
             "flash_f32": dict(rtol=2e-5, atol=2e-5),
             "bf16": dict(rtol=2 ** -7, atol=1e-2)}
# card (kernels, cuBLAS) vs CPU, and prefill (flash) vs streamed decode
# (plain grouped attention): f32 through the whole model, max abs error
# over the largest magnitude
SERVE_REL = 1e-4
# a forward with grad mode off (the kernels) vs with it on (plain), same card
EVAL_RTOL = 1e-5
KERNELS = ("fused_adamw_stats", "fused_adamw", "fused_stats", "sqdiff_norm",
           "rmsnorm", "flash_attention")


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
                                  "adamw_groups": (adamw_groups(wrap.flat_layout)
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


def adamw_groups(layout) -> int:
    """Launches of `fused_adamw_stats` a step: one per (p, g) dtype pair, and
    the step's gradients are f32 whatever the params' dtype."""
    return len(set(layout.buffer_dtypes))


def check_bucket_kernels(dev, tol, hyper, sum_rtol, shard_layout):
    """Phase 3, the list entry points: `fused_adamw_stats_buckets` and
    `fused_stats_buckets` against the plain versions bucket by bucket, over
    ragged sizes with an unaligned entry and three dtype groups in one call,
    and over rank 1's shard views of microllama's J = 2 layout.  Each case
    runs twice, the second time on copies of the inputs, and must give the
    same bits; each call launches once per dtype group.  Returns each
    kernel's largest error."""
    from repro_torch.distributed.sharding import shard_bucket
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adamw import (
        adamw_scalars, fused_adamw_stats, fused_adamw_stats_buckets)
    from repro_torch.kernels.fused_stats import fused_stats, fused_stats_buckets

    f32, bf16 = torch.float32, torch.bfloat16
    ragged = [(n, 0, f32, f32) for n in (1, 17, 2048, 1_000_003, 5_767_168)]
    ragged += [(2048, 1, f32, f32), (4099, 0, bf16, bf16), (1_000_003, 0, bf16, bf16),
               (17, 0, bf16, f32), (1_048_576, 0, bf16, f32)]

    def views(n, off, dt, seed, scale):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (scale * torch.randn(n + off, device=dev, generator=gen)).to(dt)[off:]

    def ragged_case():
        return [[views(n, off, pd, 4 * i, 0.02), views(n, off, gd, 4 * i + 1, 1e-3),
                 views(n, off, f32, 4 * i + 2, 1e-4),
                 views(n, off, f32, 4 * i + 3, 1e-3) ** 2]
                for i, (n, off, pd, gd) in enumerate(ragged)], 3

    def shard_case():
        full = [[views(n, 0, f32, 4 * i + k, s) for k, s in enumerate((0.02, 1e-3, 1e-4, 1e-3))]
                for i, n in enumerate(shard_layout.buffer_sizes)]
        for b in full:
            b[3] = b[3] ** 2
        return [[shard_bucket(x, 1, 2) for x in b] for b in full], 1

    err = {"fused_adamw_stats": 0.0, "fused_stats": 0.0}
    sc = dict(lr=torch.tensor(3e-4, device=dev), c1=torch.tensor(1 - 0.9 ** 3, device=dev),
              c2=torch.tensor(1 - 0.95 ** 3, device=dev), clip_scale=torch.tensor(0.37, device=dev))
    scalars = adamw_scalars(*sc.values(), dev)
    for name, make in (("ragged", ragged_case), ("microllama J=2 shards", shard_case)):
        bufs, groups = make()
        copies = [[x.clone() for x in b] for b in bufs]
        want = [ref.adamw_stats_ref(*b, **sc, **hyper) for b in bufs]
        stats_want = [ref.fused_stats_ref(b[1], b[0]) for b in bufs]
        before = fused_adamw_stats.launches, fused_stats.launches
        dsq, ysq = fused_stats_buckets([b[1] for b in bufs], [b[0] for b in bufs])
        dsq2, ysq2 = fused_stats_buckets([b[1] for b in bufs], [b[0] for b in bufs])
        gsq = fused_adamw_stats_buckets(*zip(*bufs), scalars, **hyper)
        gsq2 = fused_adamw_stats_buckets(*zip(*copies), scalars, **hyper)
        torch.cuda.synchronize()
        launched = (fused_adamw_stats.launches - before[0], fused_stats.launches - before[1])
        if launched != (2 * groups, 2 * groups):
            raise AssertionError(f"{name}: launches {launched}, expected {groups} "
                                 f"dtype groups a call")
        if not (torch.equal(gsq, gsq2) and torch.equal(dsq, dsq2) and torch.equal(ysq, ysq2)):
            raise AssertionError(f"{name}: sums not bit-identical on repeat: "
                                 f"{[float(x) for x in (gsq, gsq2, dsq, dsq2, ysq, ysq2)]}")
        for b, c, w in zip(bufs, copies, want):
            for got, copy, expect in zip((b[0], b[2], b[3]), (c[0], c[2], c[3]), w):
                if not torch.equal(got, copy):
                    raise AssertionError(f"{name}: p, m or v not bit-identical on repeat")
                torch.testing.assert_close(got, expect, **tol[got.dtype])
                err["fused_adamw_stats"] = max(err["fused_adamw_stats"],
                                               float((got.float() - expect.float()).abs().max()))
        sums = {"gsq": (gsq, sum(w[3] for w in want)),
                "dsq": (dsq, sum(w[0] for w in stats_want)),
                "ysq": (ysq, sum(w[1] for w in stats_want))}
        for got, expect in sums.values():
            torch.testing.assert_close(got, expect, rtol=sum_rtol, atol=0.0)
        err["fused_stats"] = max(err["fused_stats"], *(float((sums[k][0] - sums[k][1]).abs())
                                                       for k in ("dsq", "ysq")))
        say("check", kernel="fused_adamw_stats_buckets+fused_stats_buckets", case=name,
            buckets=len(bufs), elements=sum(b[0].numel() for b in bufs),
            dtype_groups=groups, launches_per_call=groups, bit_identical_repeat=True,
            **{f"{k}_rel_err": float(((g - w) / w).abs()) for k, (g, w) in sums.items()})
        del bufs, copies, want, stats_want
        gc.collect()
    torch.cuda.empty_cache()
    return err


def time_tail(dev, sizes):
    """Phase 8, the step's tail as FSDP-Norm calls it over microllama's
    layout: the statistic over the full g_j and g buckets
    (`worker_variance_stats_buffers`), then the AdamW update of the
    worker's shards (`_sharded_buffer_update`), at J = 1 and on rank 1's
    1/2 shards of J = 2 (one process: no collective).  The earlier calling
    pattern (one call a bucket, as the step made them before the list
    calls) and the step's own (one call over every bucket) run in turns;
    host clock around work that ends in `synchronize()`, and the host's
    own time until the calls return."""
    from repro_torch.core.norm_test import worker_variance_stats_buffers
    from repro_torch.distributed.sharding import shard_bucket
    from repro_torch.distributed.train_step import _sharded_buffer_update
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import pmean
    from repro_torch.optim.adamw import (
        AdamWConfig, _bias_corrections, clip_scale_from_norm)

    cfg = AdamWConfig()
    gen = torch.Generator(device=dev).manual_seed(13)
    g_j = [1e-3 * torch.randn(n, device=dev, generator=gen) for n in sizes]
    g = [1e-3 * torch.randn(n, device=dev, generator=gen) for n in sizes]
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
    out = {}
    for J in (1, 2):
        idx = J - 1
        pb = [0.02 * torch.randn(n // J, device=dev, generator=gen) for n in sizes]
        opt = {"m": tuple(torch.zeros(n // J, device=dev) for n in sizes),
               "v": tuple(torch.zeros(n // J, device=dev) for n in sizes),
               "count": torch.zeros((), dtype=torch.int32, device=dev)}

        def new():
            _, gsq = worker_variance_stats_buffers(g_j, g)
            _sharded_buffer_update(pb, g, opt, cfg, 3e-4, gsq, idx, J)

        def old():
            local_sq, gsq = zero(), zero()
            for a, b in zip(g_j, g):
                d, q = ops.stats_flat(a, b)
                local_sq = local_sq + d
                gsq = gsq + q
            pmean(local_sq)
            c1, c2 = _bias_corrections(cfg, opt["count"] + 1)
            lr = torch.as_tensor(3e-4, dtype=torch.float32).to(dev)
            scale = clip_scale_from_norm(torch.sqrt(gsq), cfg.grad_clip)
            for p, gl, m, v in zip(pb, [shard_bucket(b, idx, J) for b in g],
                                   opt["m"], opt["v"]):
                ops.adamw_flat(p, gl, m, v, lr=lr, beta1=cfg.beta1, beta2=cfg.beta2,
                               eps=cfg.eps, weight_decay=cfg.weight_decay, c1=c1,
                               c2=c2, clip_scale=scale)

        res = {k: {"ms": [], "host_ms": []} for k in ("per_bucket", "one_call")}
        fns = {"per_bucket": old, "one_call": new}
        for fn in fns.values():
            fn()                                 # warm-up (tables, allocator)
        for rep in range(10):
            for k in (("per_bucket", "one_call") if rep % 2 == 0
                      else ("one_call", "per_bucket")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k]()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                res[k]["host_ms"].append(1e3 * (t1 - t0))
                res[k]["ms"].append(1e3 * (time.perf_counter() - t0))
        for r in res.values():
            r["median_ms"] = sorted(r["ms"])[len(r["ms"]) // 2]
            r["median_host_ms"] = sorted(r["host_ms"])[len(r["host_ms"]) // 2]
        out[f"J={J}"] = {"buckets": len(sizes), "shard_elements": sum(sizes) // J, **res}
        del pb, opt
    return out


def rel_err(got, want) -> float:
    """Max abs error over the largest magnitude of `want` (f32)."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def caches_rel_err(a, b) -> float:
    return max(rel_err(x[k], y[k]) for x, y in zip(a, b) for k in ("k", "v"))


def check_serving_kernels(dev):
    """Phase serve-check: rmsnorm and flash_attention against their plain
    versions on the card; ends with each kernel's max abs error by dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    f32, bf16 = torch.float32, torch.bfloat16
    tol = lambda dt, k: SERVE_TOL[k] if dt == f32 else SERVE_TOL["bf16"]
    err = {f"{k}/{dt}": 0.0 for k in ("rmsnorm", "flash_attention")
           for dt in ("float32", "bfloat16")}
    say("serve-check", tolerances=SERVE_TOL)
    rows_d = [(r, d) for r in (1, 7, 4096, 16384) for d in (64, 100, 2048, 2050, 8192)]
    cases = [(r, d, xd, sd, 0) for r, d in rows_d
             for xd, sd in ((f32, f32), (bf16, bf16), (bf16, f32))]
    cases += [(r, d, f32, f32, 1) for r, d in ((7, 2048), (4096, 2048), (7, 100))]
    for rows, d, xd, sd, offset in cases:
        gen = torch.Generator(device=dev).manual_seed(rows * d + offset)
        x = torch.randn(rows * d + offset, device=dev, generator=gen).to(xd)
        x = x[offset:].view(rows, d)
        scale = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(sd)
        with torch.inference_mode():
            got = rmsnorm(x, scale)
            again = rmsnorm(x, scale)
        want = ref.rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"rmsnorm not bit-identical on repeat: {rows}x{d}")
        torch.testing.assert_close(got, want, **tol(xd, "rmsnorm_f32"))
        e = float((got.float() - want.float()).abs().max())
        key = f"rmsnorm/{str(xd)[6:]}"
        err[key] = max(err[key], e)
        if rows in (7, 4096) or offset:
            say("serve-check", kernel="rmsnorm", rows=rows, d=d, x=str(xd),
                scale=str(sd), offset=offset, max_abs_err=e)
        del x, got, again, want
    shapes = [  # b, t, s, causal, window, softcap
        (1, 64, 64, True, 0, 0.0), (2, 100, 100, True, 0, 30.0),
        (1, 77, 130, True, 100, 0.0), (1, 200, 60, True, 50, 0.0),
        (2, 300, 300, True, 100, 30.0), (1, 96, 150, False, 0, 0.0),
        (1, 130, 200, False, 100, 30.0), (1, 520, 520, True, 0, 0.0)]
    i = 0
    for d in (16, 32, 33, 64, 100, 128):       # 33: 4-byte copies; bf16 plain loads
        for h, kvh in ((8, 8), (8, 2), (8, 1)):
            for dt in (f32, bf16):
                b, t, sl, causal, window, cap = shapes[i % len(shapes)]
                i += 1
                gen = torch.Generator(device=dev).manual_seed(i)
                q, k, v = (torch.randn(b, n, hh, d, device=dev, generator=gen).to(dt)
                           for n, hh in ((t, h), (sl, kvh), (sl, kvh)))
                kw = dict(causal=causal, window=window, softcap=cap)
                with torch.inference_mode():
                    got = flash_attention(q, k, v, **kw)
                want = ref.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **tol(dt, "flash_f32"))
                e = float((got.float() - want.float()).abs().max())
                key = f"flash_attention/{str(dt)[6:]}"
                err[key] = max(err[key], e)
                say("serve-check", kernel="flash_attention", b=b, t=t, s=sl, h=h,
                    kvh=kvh, d=d, dtype=str(dt), **kw, max_abs_err=e)
    say("serve-check", max_abs_err=err)


def check_dense_configs(ops, dev):
    """Phase serve-check, last part: every dense config of the port at full
    width and 1 layer.  A forward with grad mode off (training's eval loss)
    runs the kernels and must agree with the plain forward under grad mode;
    prefill must agree with the same tokens streamed through decode."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.distributed.serve_step import make_decode_step, make_prefill
    from repro_torch.models.model import build_model

    for arch in ALL_ARCHS:
        cfg = get_config(arch).replace(num_layers=1)
        model = build_model(cfg)
        params = model.init(0, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=dev, generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (2, 100), device=dev, generator=gen)
        batch = {"tokens": tokens, "labels": labels}
        plain = float(model.loss(params, batch)[0])
        ops.reset_launch_counts()
        with torch.no_grad():
            fast = float(model.loss(params, batch)[0])
        launches = ops.launch_counts()
        if (launches["flash_attention"], launches["rmsnorm"]) != (1, 3):
            raise AssertionError(f"{arch}: no-grad forward launched {launches}")
        if not close(fast, plain, EVAL_RTOL):
            raise AssertionError(f"{arch}: no-grad loss {fast} vs plain {plain}")
        logits, caches = make_prefill(model)(params, {"tokens": tokens})
        step = make_decode_step(model)
        cache = model.init_cache(2, tokens.shape[1], device=dev)
        for i in range(tokens.shape[1]):
            dec, cache = step(params, cache, tokens[:, i], i)
        errs = {"last_logits": rel_err(logits, dec), "caches": caches_rel_err(caches, cache)}
        if max(errs.values()) > SERVE_REL:
            raise AssertionError(f"{arch}: prefill vs streamed decode {errs} > {SERVE_REL}")
        say("serve-check", arch=arch, layers=1, head_dim=cfg.head_dim,
            eval_loss={"no_grad": fast, "plain": plain}, rtol=EVAL_RTOL,
            rel_tol=SERVE_REL, rel_errs=errs)
        del params, logits, caches, cache, dec
        gc.collect()
        torch.cuda.empty_cache()


def serve_ref(smi):
    """Phase serve-ref: llama3.2-1b at full width and 2 layers, the same
    parameters on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import make_decode_step, make_prefill
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    cfg = get_config(SERVE_ARCH).replace(num_layers=2)
    model = build_model(cfg)
    params = {"cpu": model.init(0, "cpu")}
    params["cuda"] = tree_map(lambda x: x.to("cuda", copy=True), params["cpu"])
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    out = {}
    for d in ("cpu", "cuda"):
        logits, caches = make_prefill(model)(params[d], {"tokens": tokens.to(d)})
        step = make_decode_step(model)
        cache = model.init_cache(2, 16, device=d)
        dec = []
        for i in range(8):   # per-row: the second row runs 3 positions behind
            pos = torch.tensor([i + 3, i], device=d)
            lg, cache = step(params[d], cache, tokens[:, i].to(d), pos)
            dec.append(lg)
        served = run_serving(SERVE_ARCH, smoke=False, batch=2, prompt_len=16,
                             gen_len=8, params=params[d])
        out[d] = (logits, caches, dec, cache, served["tokens"])
    cpu, card = out["cpu"], out["cuda"]
    errs = {"prefill_logits": rel_err(card[0], cpu[0]),
            "prefill_caches": caches_rel_err(card[1], cpu[1]),
            "decode_logits": max(rel_err(a, b) for a, b in zip(card[2], cpu[2])),
            "decode_caches": caches_rel_err(card[3], cpu[3])}
    if max(errs.values()) > SERVE_REL:
        raise AssertionError(f"card vs CPU serving: {errs} > {SERVE_REL}")
    if not (card[4] == cpu[4]).all():
        raise AssertionError(f"run_serving tokens differ: card {card[4].tolist()} "
                             f"vs CPU {cpu[4].tolist()}")
    say("serve-ref", arch=SERVE_ARCH, layers=2, rel_tol=SERVE_REL, rel_errs=errs,
        tokens=card[4].tolist())


def serve_path(smi, ops, dev):
    """Phase serve: serving's main path at full width.  Returns the launch
    counts of the path's runs, summed."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import make_decode_step, make_prefill
    from repro_torch.launch.serve import run_continuous_serving, run_serving
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           device=dev, generator=gen)
    prefill = make_prefill(model)
    prefill(params, {"tokens": tokens[:, :64]})          # cuBLAS warm-up
    total = {k: 0 for k in KERNELS}

    def counted(fn, name):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        for k in KERNELS:
            total[k] += launches[k]
        if not launches["rmsnorm"]:
            raise AssertionError(f"{name}: rmsnorm never launched: {launches}")
        return out, secs, launches

    (logits, caches), prefill_s, launches = counted(
        lambda: prefill(params, {"tokens": tokens}), "prefill")
    layers = cfg.num_layers
    want = {k: 0 for k in KERNELS} | {"flash_attention": layers,
                                      "rmsnorm": 2 * layers + 1}
    if launches != want:
        raise AssertionError(f"prefill launched {launches}, expected {want}")
    if logits.shape != (PREFILL_BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite of the expected shape")
    prefill_ms = [1e3 * prefill_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    # the same tokens streamed through decode (the plain grouped attention)
    step = make_decode_step(model)
    cache = model.init_cache(PREFILL_BATCH, PREFILL_LEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PREFILL_LEN):
        dec, cache = step(params, cache, tokens[:, i], i)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    errs = {"last_logits": rel_err(logits, dec), "caches": caches_rel_err(caches, cache)}
    if max(errs.values()) > SERVE_REL:
        raise AssertionError(f"prefill vs streamed decode: {errs} > {SERVE_REL}")
    prefill_peak = torch.cuda.max_memory_allocated()
    del caches, cache, dec, logits
    gc.collect()
    torch.cuda.empty_cache()
    say("serve", part="prefill", nvidia_smi=smi, arch=SERVE_ARCH, layers=layers,
        params=sum(x.numel() for x in tree_leaves(params)),
        batch=PREFILL_BATCH, tokens=PREFILL_LEN, launches=launches,
        prefill_ms=prefill_ms,
        prefill_tok_per_s=PREFILL_BATCH * PREFILL_LEN / (min(prefill_ms) / 1e3),
        streamed_decode_s=stream_s, rel_tol=SERVE_REL, rel_errs=errs,
        peak_mem_bytes=prefill_peak)

    torch.cuda.reset_peak_memory_stats()
    res, secs, launches = counted(lambda: run_serving(
        SERVE_ARCH, smoke=False, params=params, **SERVE_JOB), "run_serving")
    steps = SERVE_JOB["prompt_len"] + SERVE_JOB["gen_len"] - 1
    want = {k: 0 for k in KERNELS} | {"rmsnorm": (2 * layers + 1) * steps}
    if launches != want:
        raise AssertionError(f"run_serving launched {launches}, expected {want}")
    if res["tokens"].shape != (SERVE_JOB["batch"], SERVE_JOB["gen_len"]):
        raise AssertionError(f"run_serving tokens {res['tokens'].shape}")
    say("serve", part="run_serving", nvidia_smi=smi, **SERVE_JOB, launches=launches,
        prefill_s=res["prefill_s"], decode_s=res["decode_s"],
        decode_tok_per_s=res["decode_tok_per_s"],
        decode_ms_per_step=1e3 * res["decode_s"] / (SERVE_JOB["gen_len"] - 1),
        peak_mem_bytes=torch.cuda.max_memory_allocated(), wall_s=secs)

    torch.cuda.reset_peak_memory_stats()
    res, secs, launches = counted(lambda: run_continuous_serving(
        SERVE_ARCH, smoke=False, params=params, **CONT_JOB), "continuous")
    eng = res["engine"]
    want = {k: 0 for k in KERNELS} | {"rmsnorm": (2 * layers + 1) * eng["steps"]}
    if launches != want:
        raise AssertionError(f"continuous serving launched {launches}, expected {want}")
    if not res["probe"]["steady_state_transition_hit"] or not res["requests_completed"]:
        raise AssertionError(f"continuous serving: {res['probe']}, "
                             f"{res['requests_completed']} completed")
    say("serve", part="continuous", nvidia_smi=smi, **CONT_JOB, launches=launches,
        load=res["load"], wall_s=res["wall_s"],
        with_probe={"requests": res["requests_completed"],
                    "req_per_s": res["sustained_req_per_s"],
                    "p50_latency_s": res["p50_latency_s"],
                    "p99_latency_s": res["p99_latency_s"],
                    "decode_tok_per_s": res["decode_tok_per_s"]},
        probe=res["probe"], engine=eng, rung_trace=res["rung_trace"],
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def time_serving_kernels(dev, bw):
    """Phase 8's serving part: rmsnorm and flash_attention at prefill's
    shapes, their plain versions and library calls, CUDA events."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    gen = torch.Generator(device=dev).manual_seed(11)
    rows, d = PREFILL_BATCH * PREFILL_LEN, 2048            # (8192, 2048)
    x = torch.randn(rows, d, device=dev, generator=gen)
    scale = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
    b, t, h, kvh, hd = PREFILL_BATCH, PREFILL_LEN, 32, 8, 64
    q = torch.randn(b, t, h, hd, device=dev, generator=gen)
    k = torch.randn(b, t, kvh, hd, device=dev, generator=gen)
    v = torch.randn(b, t, kvh, hd, device=dev, generator=gen)
    out = {}
    with torch.inference_mode():
        want = ref.rmsnorm_ref(x, scale)
        got = rmsnorm(x, scale)
        torch.testing.assert_close(got, want, **SERVE_TOL["rmsnorm_f32"])
        out["rmsnorm"] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": [cuda_ms(lambda: rmsnorm(x, scale), 50) for _ in range(2)],
            "plain_ms": [cuda_ms(lambda: ref.rmsnorm_ref(x, scale), 20) for _ in range(2)],
            "library_ms": [cuda_ms(lambda: F.rms_norm(x, (d,), scale, 1e-6), 50)
                           for _ in range(2)],
            "bound_bytes_ms": (2 * x.numel() + d) * 4 / bw * 1e3,
            # x*x, +, the divide and the scale: 4 flops an element
            "bound_ops_ms": 4 * x.numel() / F32_FLOPS * 1e3,
            "shape": [rows, d]}
        del want, got
        want = ref.flash_attention_ref(q, k, v, causal=True)
        got = flash_attention(q, k, v, causal=True)
        torch.testing.assert_close(got, want, **SERVE_TOL["flash_f32"])
        out["flash_attention"] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": [cuda_ms(lambda: flash_attention(q, k, v, causal=True), 5)
                   for _ in range(2)],
            "plain_ms": [cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 2)
                         for _ in range(2)],
            "library_ms": [cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), 5) for _ in range(2)],
            "bound_bytes_ms": 2 * (q.numel() + k.numel()) * 4 / bw * 1e3,
            # q.k and p.v, 2 flops a multiply-add each, over the visible
            # (query, key) pairs of the causal mask: t(t+1)/2 a head; on the
            # CUDA cores in f32, and as the kernel runs them: three TF32
            # products each on the tensor cores
            "bound_ops_ms": 4 * b * h * hd * t * (t + 1) / 2 / F32_FLOPS * 1e3,
            "bound_tc_ms": 3 * 4 * b * h * hd * t * (t + 1) / 2 / TF32_FLOPS * 1e3,
            "shape": [b, t, h, kvh, hd]}
        del want, got
        # the kernel on bf16 copies, with SDPA on the same copies as a
        # second yardstick (timed only: the port never calls it)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        want = ref.flash_attention_ref(qb, kb, vb, causal=True)
        got = flash_attention(qb, kb, vb, causal=True)
        torch.testing.assert_close(got, want, **SERVE_TOL["bf16"])
        out["flash_attention"]["bf16"] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": [cuda_ms(lambda: flash_attention(qb, kb, vb, causal=True), 5)
                   for _ in range(2)],
            "library_bf16_ms": [cuda_ms(lambda: F.scaled_dot_product_attention(
                qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
                is_causal=True, enable_gqa=True), 5) for _ in range(2)]}
    return out


# crash-safe training: the jobs of phases resume-accum and resume-fsdp.
# total_samples is fixed (TRAIN_JOB's 6 x 32), so a run cut short at step 4
# sees the same learning rates as the 6-step run; an eval at steps 3 and 6
# puts rmsnorm and flash_attention (grad mode off) on the resumed path too
RESUME_JOB = dict(TRAIN_JOB, total_samples=6 * 32, eval_every=3, eval_batches=1)
RESUME_FSDP_JOB = dict(RESUME_JOB, step_impl="fsdp_norm", mesh_data=2,
                       dist_backend="gloo")
# the mixed and local-SGD phases: microllama-300m at full width, 2 layers
SMALL_LAYERS = 2
LOCAL_H = 2
# a residency combination against tree/tree on the card, 2 steps: metrics
# and params (f32; AdamW moves an entry whose gradient is within a few eps
# of zero by up to lr = 1e-3 on last-bit differences in the clip scale)
MIXED_TOL = 1e-5
# estimators: eq. 3 and eq. 4 on the card against the CPU
EST_RTOL = 1e-5


def cli_args(job: dict) -> list:
    """`python -m repro_torch.launch.train` arguments for a TrainJob dict."""
    args = []
    for k, v in job.items():
        if k == "smoke":
            args += [] if v else ["--full-size"]
        elif isinstance(v, bool):
            args += [f"--{k.replace('_', '-')}"] if v else []
        else:
            args += [f"--{k.replace('_', '-')}", str(v)]
    return args


def same_checkpoint(dir_a: str, dir_b: str, step: int) -> int:
    """Raise unless the two checkpoints of `step` hold bit-identical arrays
    (params, moments, count) and equal controller state and samples
    cursor; returns the npz's bytes."""
    import numpy as np
    name = f"ckpt_{step:08d}"
    a, b = (np.load(Path(d, f"{name}.npz")) for d in (dir_a, dir_b))
    if sorted(a.files) != sorted(b.files):
        raise AssertionError(f"checkpoint entries differ: {a.files} vs {b.files}")
    for k in a.files:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"checkpoint entry {k} differs between {dir_a} "
                                 f"and {dir_b}")
    ma, mb = (json.loads(Path(d, f"{name}.json").read_text()) for d in (dir_a, dir_b))
    for k in ("controller", "samples", "step"):
        if ma[k] != mb[k]:
            raise AssertionError(f"checkpoint {k} differs: {ma[k]} vs {mb[k]}")
    return Path(dir_a, f"{name}.npz").stat().st_size


def same_suffix(resumed: dict, ref: dict, k: int):
    """Raise unless the resumed run's history equals the uninterrupted run's
    from step k+1 on, bit for bit."""
    if resumed["resumed_from"] != k:
        raise AssertionError(f"resumed from {resumed['resumed_from']}, not {k}")
    for key in ("loss", "global_batch", "samples", "var_l1", "val_loss"):
        got, want = resumed[key], ref[key][k:]
        if [repr(x) for x in got] != [repr(x) for x in want]:
            raise AssertionError(f"resumed {key} {got} != uninterrupted {want}")


class CheckpointTimer:
    """Times the checkpoint work of `run_training` in this process: the
    gather and conversion to the on-disk layout, the npz write (fsync
    included), the read, and the conversion back to the job's residency on
    the card (host clock; the copy to the card ends in a sync)."""

    def __init__(self):
        from repro_torch.launch import train as T
        self.T, self.secs, self.saved = T, {}, []
        L = T._CheckpointLayout
        self.patched = [(T, "save_checkpoint"), (T, "restore_checkpoint"),
                        (L, "to_reference"), (L, "from_reference")]
        self.orig = [getattr(o, n) for o, n in self.patched]
        for (obj, name), fn in zip(self.patched, self.orig):
            setattr(obj, name, self.timed(name, fn))

    def timed(self, name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.secs.setdefault(name, []).append(round(time.perf_counter() - t0, 3))
            return out
        return run

    def close(self):
        for (obj, name), fn in zip(self.patched, self.orig):
            setattr(obj, name, fn)


def resume_accum(smi, ops, layout):
    """Phase resume-accum: full-width microllama-300m, ACCUM-NORM, flat
    stats and params.  An uninterrupted 6-step run (one checkpoint, at
    the end); the same job in a child process with a checkpoint every 2
    steps, killed by the fault harness (SIGKILL) at the top of step 5;
    `run_training(resume=True)` to step 6.  Losses, batches, var_l1 and the
    eval losses must equal the uninterrupted run's bit for bit, and so
    must the step-6 checkpoints (params, moments, count, controller state,
    samples cursor).  The checkpoint directory is removed at the end,
    passed or failed."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint.store import latest_step
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainJob, run_training

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    say("resume-accum", part="start", nvidia_smi=smi, tmpdir=tmp, free_bytes=free)
    timer = CheckpointTimer()
    try:
        t0 = time.time()
        ref = run_training(TrainJob(**RESUME_JOB, checkpoint_dir=f"{tmp}/ref"))
        ref = {k: ref[k] for k in ("loss", "global_batch", "samples", "var_l1",
                                   "val_loss", "time")}
        gc.collect()
        torch.cuda.empty_cache()          # the child needs the card's memory
        run = dict(RESUME_JOB, checkpoint_dir=f"{tmp}/run", checkpoint_every=2)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_FAULTS=json.dumps([{"site": "train.step", "at": 5,
                                             "action": "die"}]))
        t1 = time.time()
        child = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                                *cli_args(run)], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=600)
        child_s = time.time() - t1
        if child.returncode != -9:
            raise AssertionError(f"the child was to die by SIGKILL at step 5; exit "
                                 f"{child.returncode}\n{child.stdout[-2000:]}\n"
                                 f"{child.stderr[-4000:]}")
        if latest_step(run["checkpoint_dir"]) != 4:
            raise AssertionError(f"latest checkpoint {latest_step(run['checkpoint_dir'])}"
                                 f", expected 4: {os.listdir(run['checkpoint_dir'])}")
        ops.reset_launch_counts()
        resumed = run_training(TrainJob(**run, resume=True))
        launches = ops.launch_counts()
        same_suffix(resumed, ref, 4)
        groups = adamw_groups(layout)
        layers = get_config(TRAIN_JOB["arch"]).num_layers
        want = {k: 0 for k in KERNELS} | {"fused_adamw_stats": 2 * groups,
                                          "flash_attention": layers,
                                          "rmsnorm": 2 * layers + 1}
        if launches != want:
            raise AssertionError(f"resumed path launched {launches}, expected {want}")
        nbytes = same_checkpoint(f"{tmp}/ref", run["checkpoint_dir"], 6)
        written = sum(f.stat().st_size for f in Path(tmp).rglob("ckpt_*"))
        step_ms = [round(1e3 * (b - a), 3)
                   for a, b in zip([0.0] + resumed["time"][:-1], resumed["time"])]
        say("resume-accum", nvidia_smi=smi, bit_identical=True, killed_at_step=5,
            resumed_from=4, loss=resumed["loss"], global_batch=resumed["global_batch"],
            val_loss=resumed["val_loss"], launches=launches,
            resumed_step_ms=step_ms, checkpoint_bytes=nbytes, bytes_written=written,
            checkpoints=sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*.npz")),
            seconds=timer.secs, child_s=round(child_s, 3),
            phase_s=round(time.time() - t0, 3), free_bytes_before=free)
    finally:
        timer.close()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def resume_fsdp_rank(job, root):
    """One rank of phase resume-fsdp: the uninterrupted 6-step run (one
    checkpoint, at the end), a 4-step run with a checkpoint every 2 steps,
    and a fresh `run_training(resume=True)` to step 6, in one process
    group.  Returns rank 0's histories."""
    from repro_torch.launch.train import TrainJob, run_training
    keep = ("loss", "global_batch", "samples", "var_l1", "val_loss",
            "resumed_from", "time", "ranks")
    runs = (("ref", dict(checkpoint_dir=f"{root}/ref")),
            ("first", dict(steps=4, checkpoint_dir=f"{root}/run",
                           checkpoint_every=2)),
            ("resumed", dict(checkpoint_dir=f"{root}/run", checkpoint_every=2,
                             resume=True)))
    out = {}
    for name, over in runs:
        t0 = time.time()
        hist = run_training(TrainJob(**{**job, **over}))
        out[name] = {k: hist[k] for k in keep} | {"wall_s": time.time() - t0}
        del hist
        gc.collect()
        torch.cuda.empty_cache()
    return out


def resume_fsdp(smi, fsdp_layout):
    """Phase resume-fsdp: two gloo ranks share the card, FSDP-Norm on
    full-width microllama-300m with flat stats and params: the param and
    moment shards are gathered into whole buffers on save (rank 0 writes)
    and re-split on resume.  The resumed run and its step-6 checkpoint must
    equal the uninterrupted run's bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_workers

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    try:
        t0 = time.time()
        out = spawn_workers(resume_fsdp_rank, 2, RESUME_FSDP_JOB, tmp, backend="gloo")
        same_suffix(out["resumed"], out["ref"], 4)
        nbytes = same_checkpoint(f"{tmp}/ref", f"{tmp}/run", 6)
        layers = get_config(TRAIN_JOB["arch"]).num_layers
        want = {k: 0 for k in KERNELS} | {
            "fused_stats": 2, "fused_adamw_stats": 2 * adamw_groups(fsdp_layout),
            "flash_attention": layers, "rmsnorm": 2 * layers + 1}
        got = [r["launches"] for r in out["resumed"]["ranks"]]
        if got != [want, want]:
            raise AssertionError(f"resumed ranks launched {got}, expected {want} each")
        res = out["resumed"]
        step_ms = [round(1e3 * (b - a), 3)
                   for a, b in zip([0.0] + res["time"][:-1], res["time"])]
        say("resume-fsdp", nvidia_smi=smi, workers=2, backend="gloo",
            layers=layers, bit_identical=True, resumed_from=4, loss=res["loss"],
            global_batch=res["global_batch"], val_loss=res["val_loss"],
            launches=got, resumed_step_ms=step_ms, checkpoint_bytes=nbytes,
            bytes_written=sum(f.stat().st_size for f in Path(tmp).rglob("ckpt_*")),
            run_wall_s={k: round(v["wall_s"], 3) for k, v in out.items()},
            phase_s=round(time.time() - t0, 3), free_bytes_before=free)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def small_config():
    from repro_torch.configs import get_config
    return get_config(TRAIN_JOB["arch"]).replace(num_layers=SMALL_LAYERS)


def mixed_local_rank(cpu_params, batches, local_batch):
    """One rank of phases mixed and local-sgd (2 gloo ranks on the card and
    on the CPU).  mixed: FSDP-Norm's four residency combinations, 2 steps
    each on the card.  local-sgd: one flat-resident round (H local steps,
    flat stats) on the CPU and on the card, with its launch counts.
    Returns every rank's results (a list)."""
    import torch.distributed as dist
    from repro_torch.distributed.local_step import make_local_sgd_step
    from repro_torch.distributed.sharding import gather_flat_buffers, shard_flat_buffers
    from repro_torch.distributed.train_step import batch_to_device, make_fsdp_norm_step
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import num_workers, rank_device, worker_index
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(small_config())
    J, rank = num_workers(), worker_index()
    dev = rank_device("cuda", rank)
    out = {"mixed": {}, "local": {}}
    for stats_impl in ("tree", "flat"):
        for params_impl in ("tree", "flat"):
            params = tree_map(lambda x: x.to(dev, copy=True), cpu_params)
            wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl=stats_impl,
                                       params_impl=params_impl, params_like=params,
                                       device=dev)
            layout = wrap.flat_layout
            opt = (init_adamw_flat(params, shard_divisor=J, layout=layout, device=dev)
                   if stats_impl == "flat" else init_adamw(params))
            if params_impl == "flat":
                params = tuple(shard_flat_buffers(layout.flatten(params)))
            mets = []
            for b in batches:
                params, opt, m = wrap(b)(params, opt, batch_to_device(b, dev), 1e-3)
                mets.append({k: float(m[k]) for k in METRICS})
            full = (layout.unflatten(gather_flat_buffers(list(params)))
                    if params_impl == "flat" else params)
            out["mixed"][f"{stats_impl}/{params_impl}"] = {
                "metrics": mets, "params": [x.detach().cpu() for x in tree_leaves(full)]}
            del params, opt, full
    for d in ("cpu", "cuda"):
        dv = rank_device(d, rank)
        params = tree_map(lambda x: x.to(dv, copy=True), cpu_params)
        wrap = make_local_sgd_step(model, AdamWConfig(), stats_impl="flat",
                                   params_impl="flat", params_like=params, device=dv)
        opt = init_adamw_flat(params, layout=wrap.flat_layout, device=dv)
        pb = tuple(wrap.flat_layout.flatten(params))
        ops.reset_launch_counts()
        pb, opt, m = wrap(local_batch)(pb, opt, batch_to_device(local_batch, dv), 1e-3)
        launches = ops.launch_counts()
        out["local"][d] = {"metrics": {k: float(v) for k, v in m.items()},
                           "launches": launches,
                           "groups": adamw_groups(wrap.flat_layout),
                           "params": [x.detach().cpu() for x in pb]}
    every = [None] * J
    dist.all_gather_object(every, {"mixed": {k: v["metrics"] for k, v in out["mixed"].items()},
                                   "local": {k: {kk: vv for kk, vv in v.items()
                                                 if kk != "params"}
                                             for k, v in out["local"].items()}})
    every[rank]["mixed_params"] = {k: v["params"] for k, v in out["mixed"].items()}
    every[rank]["local_params"] = {k: v["params"] for k, v in out["local"].items()}
    return every


def max_rel(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max() /
                     y.float().abs().max().clamp_min(1e-30)) for x, y in zip(a, b))


def mixed_and_local(smi, ops, dev):
    """Phases mixed and local-sgd.  mixed: both mixed residency
    combinations (and flat/flat) of both steps on the card, microllama-300m
    at full width and 2 layers, held against the card's tree/tree step:
    2 steps, metrics at rtol 1e-5, final params at rtol and atol 1e-5;
    ACCUM-NORM in this process,
    FSDP-Norm on 2 gloo ranks.  local-sgd: one flat-resident round of
    H = 2 local steps with flat stats on 2 gloo ranks, the card against the
    CPU's plain route (metrics at REF_RTOL); each rank's launches: one
    `fused_stats` a round and one `fused_adamw_stats` a local step per
    dtype group."""
    import numpy as np
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
    from repro_torch.launch.mesh import spawn_workers
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
    from repro_torch.tree import tree_leaves, tree_map

    cfg = small_config()
    model = build_model(cfg)
    cpu_params = model.init(0, "cpu")
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    t0 = time.time()
    # ACCUM-NORM, this process
    plan = BatchPlan(global_batch=8, micro_batch=4, accum_steps=2, workers=1)
    batches = [make_batch(src, t, plan, 128) for t in range(2)]
    accum = {}
    for stats_impl in ("tree", "flat"):
        for params_impl in ("tree", "flat"):
            params = tree_map(lambda x: x.to(dev, copy=True), cpu_params)
            wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl=stats_impl,
                                        params_impl=params_impl, params_like=params,
                                        device=dev)
            layout = wrap.flat_layout
            opt = (init_adamw_flat(params, layout=layout, device=dev)
                   if stats_impl == "flat" else init_adamw(params))
            if params_impl == "flat":
                params = tuple(layout.flatten(params))
            mets = []
            for b in batches:
                params, opt, m = wrap(b)(params, opt, batch_to_device(b, dev), 1e-3)
                mets.append({k: float(m[k]) for k in METRICS})
            full = layout.unflatten(list(params)) if params_impl == "flat" else params
            accum[f"{stats_impl}/{params_impl}"] = (
                mets, [x.detach().clone() for x in tree_leaves(full)])
            del params, opt, full
    # FSDP-Norm and local-SGD, two gloo ranks
    fplan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
    fbatches = [make_batch(src, t, fplan, 128) for t in range(2)]
    lplan = BatchPlan(global_batch=4, micro_batch=2, accum_steps=1, workers=2)
    lb = [make_batch(src, 10 + s, lplan, 64) for s in range(LOCAL_H)]
    local_batch = {k: np.stack([b[k][0] for b in lb]) for k in lb[0]}
    ranks = spawn_workers(mixed_local_rank, 2, cpu_params, fbatches, local_batch,
                          backend="gloo")
    errs, bad = {}, []
    for step_impl, runs in (("accum_norm", accum),
                            ("fsdp_norm", {k: (v, ranks[0]["mixed_params"][k])
                                           for k, v in ranks[0]["mixed"].items()})):
        o_mets, o_params = runs["tree/tree"]
        for combo, (mets, params) in runs.items():
            tag = f"{step_impl}/{combo}"
            for a, b in zip(mets, o_mets):
                bad += [f"{tag} {k}: {a[k]} vs {b[k]}" for k in METRICS
                        if not math.isclose(a[k], b[k], rel_tol=MIXED_TOL, abs_tol=1e-7)]
            errs[tag] = max(float((x.float().cpu() - y.float().cpu()).abs().max())
                            for x, y in zip(params, o_params))
            bad += [f"{tag} params" for x, y in zip(params, o_params)
                    if not torch.allclose(x.float().cpu(), y.float().cpu(),
                                          rtol=MIXED_TOL, atol=MIXED_TOL)][:1]
    say("mixed", nvidia_smi=smi, layers=SMALL_LAYERS, steps=2, rtol=MIXED_TOL,
        params_atol=MIXED_TOL, params_max_abs_diff=errs,
        fsdp_workers=2, metrics={"accum_norm": {k: v[0] for k, v in accum.items()},
                                 "fsdp_norm": ranks[0]["mixed"]})
    if bad:
        raise AssertionError(f"mixed residency vs tree/tree on the card: {bad}")
    for rank, r in enumerate(ranks):
        card, cpu = r["local"]["cuda"], r["local"]["cpu"]
        for k in ("loss", "var_l1", "grad_sqnorm"):
            if not close(card["metrics"][k], cpu["metrics"][k], REF_RTOL):
                raise AssertionError(f"rank {rank} local round, card vs CPU {k}: "
                                     f"{card['metrics'][k]} vs {cpu['metrics'][k]}")
        if cpu["launches"] != {k: 0 for k in KERNELS}:
            raise AssertionError(f"the CPU round launched {cpu['launches']}")
        want = {k: 0 for k in KERNELS} | {"fused_stats": 1,
                                          "fused_adamw_stats": LOCAL_H * card["groups"]}
        if card["launches"] != want:
            raise AssertionError(f"rank {rank} local round launched "
                                 f"{card['launches']}, expected {want}")
        if not card["metrics"]["var_l1"] > 0:
            raise AssertionError(f"no update divergence: {card['metrics']}")
    local = ranks[0]["local_params"]
    say("local-sgd", nvidia_smi=smi, layers=SMALL_LAYERS, H=LOCAL_H, workers=2,
        rtol=REF_RTOL, card=ranks[0]["local"]["cuda"]["metrics"],
        cpu=ranks[0]["local"]["cpu"]["metrics"],
        launches=[r["local"]["cuda"]["launches"] for r in ranks],
        params_rel_err=max_rel(local["cuda"], local["cpu"]),
        phase_s=round(time.time() - t0, 3))
    gc.collect()
    torch.cuda.empty_cache()


def estimators(smi, dev):
    """Phase estimators: eq. 3 (`per_sample_norm_test`, exact per-sample
    gradients by vmap) and eq. 4 (`exact_variance_test_holds`) on the
    microllama smoke config, b = 8, on the card against the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.norm_test import exact_variance_test_holds, per_sample_norm_test
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(TRAIN_JOB["arch"])
    model = build_model(cfg)
    cpu_params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (8, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss = lambda p, ex: model.loss(p, {k: v[None] for k, v in ex.items()})[0]
    out = {}
    for d in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(d, copy=True), cpu_params)
        b = {k: v.to(d) for k, v in batch.items()}
        res = per_sample_norm_test(loss, params, b, 0.2)
        grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, b)
        holds = [bool(exact_variance_test_holds(grads, eta)) for eta in (0.5, 1, 2, 4, 8)]
        out[d] = ({k: float(res[k]) for k in ("T", "lhs_over_b", "var_l1",
                                              "grad_sqnorm")}, holds)
    for k, v in out["cuda"][0].items():
        if not close(v, out["cpu"][0][k], EST_RTOL):
            raise AssertionError(f"per_sample_norm_test {k}: card {v} vs CPU "
                                 f"{out['cpu'][0][k]}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"exact_variance_test_holds: card {out['cuda'][1]} "
                             f"vs CPU {out['cpu'][1]}")
    say("estimators", nvidia_smi=smi, b=8, rtol=EST_RTOL, card=out["cuda"][0],
        cpu=out["cpu"][0], exact_test_holds=out["cuda"][1])


def child_processes() -> dict:
    """{pid: command line} of this process's children that have not been
    reaped, those of every thread."""
    out = {}
    for f in Path("/proc/self/task").glob("*/children"):
        for pid in f.read_text().split():
            try:
                cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            except OSError:
                cmd = b"?"
            out[pid] = cmd.replace(b"\0", b" ").decode(errors="replace").strip()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_adamw import (
        adamw_scalars, fused_adamw, fused_adamw_stats, fused_adamw_stats_buckets)
    from repro_torch.kernels.fused_stats import fused_stats, fused_stats_buckets
    from repro_torch.kernels.sqdiff_norm import sqdiff_norm

    t_start = time.time()
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
    # the list entry points, also over rank 1's shards of microllama's
    # J = 2 layout (only shapes are read from the parameters)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.models.model import build_model
    shard_layout = FlatLayout.from_tree(
        build_model(get_config(TRAIN_JOB["arch"])).init(0, dev), shard_divisor=2,
        device=dev)
    list_err = check_bucket_kernels(dev, tol, hyper, sum_rtol, shard_layout)
    check_serving_kernels(dev)
    check_dense_configs(ops, dev)

    # 4. the card's step against the CPU's on a small model -------------------
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
    from repro_torch.launch.mesh import spawn_workers
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
        zero = {k: 0 for k in KERNELS}
        # the flat tail: one launch a step of each list kernel per dtype group
        want = {"flat": zero | {"fused_stats": steps,
                                "fused_adamw_stats": steps * out["flat/cuda"]["adamw_groups"]},
                "tree": zero | {"fused_adamw": steps * out["tree/cuda"]["leaves"],
                                "sqdiff_norm": out["tree/cuda"]["leaves"]}}
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

    # serve-ref: serving, card against CPU, llama3.2-1b full width, 2 layers
    serve_ref(smi)

    # 6. slice 1's path: ACCUM-NORM, full-width microllama-300m ----------------
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
    expect = TRAIN_JOB["steps"] * adamw_groups(layout)
    if launches != {k: 0 for k in KERNELS} | {"fused_adamw_stats": expect}:
        raise AssertionError(f"ACCUM-NORM launches {launches}, expected "
                             f"{expect} fused_adamw_stats (one a step per dtype "
                             f"group) and nothing else")
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
    steps = FSDP_JOB["steps"]
    for rank, r in enumerate(hist["ranks"]):
        want = {k: 0 for k in KERNELS} | {"fused_stats": steps,
                                          "fused_adamw_stats": steps * adamw_groups(fsdp_layout)}
        if r["launches"] != want:
            raise AssertionError(f"rank {rank} launched {r['launches']}, expected "
                                 f"{want} (one a step per dtype group, over "
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

    # serve: serving's main path, full-width llama3.2-1b -----------------------
    serve_launches = serve_path(smi, ops, dev)

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

    # the list entry points over the whole layout, on copies (one launch
    # each: the layout is one f32 group)
    pb, gb, mb, vb = (list(x) for x in zip(*bufs))
    copies = [x.clone() for x in pb], [x.clone() for x in mb], [x.clone() for x in vb]
    ops.reset_launch_counts()
    gsq = fused_adamw_stats_buckets(copies[0], gb, copies[1], copies[2], scal, **hyper)
    dsq, ysq = fused_stats_buckets(mb, gb)
    if ops.launch_counts() != {k: 0 for k in KERNELS} | {"fused_adamw_stats": 1,
                                                        "fused_stats": 1}:
        raise AssertionError(f"list calls over the layout launched {ops.launch_counts()}")
    want = {"gsq": torch.zeros((), device=dev), "dsq": torch.zeros((), device=dev),
            "ysq": torch.zeros((), device=dev)}
    for i, (p, g, m, v) in enumerate(bufs):
        w = ref.adamw_stats_ref(p, g, m, v, clip_scale=scal[3], **ref_kw)
        for got, expect in zip((copies[0][i], copies[1][i], copies[2][i]), w):
            torch.testing.assert_close(got, expect, **tol[f32])
            err["fused_adamw_stats"] = max(err["fused_adamw_stats"],
                                           float((got - expect).abs().max()))
        want["gsq"] += w[3]
        d, q = ref.fused_stats_ref(m, g)
        want["dsq"] += d
        want["ysq"] += q
        del w
    for got, k in ((gsq, "gsq"), (dsq, "dsq"), (ysq, "ysq")):
        torch.testing.assert_close(got, want[k], rtol=sum_rtol, atol=0.0)
    err["fused_stats"] = max(err["fused_stats"], float((dsq - want["dsq"]).abs()),
                             float((ysq - want["ysq"]).abs()))
    err = {k: max(e, list_err.get(k, 0.0)) for k, e in err.items()}
    del copies
    gc.collect()

    over_layout = lambda fn: (lambda: [fn(*b) for b in bufs])
    lists = {"fused_adamw_stats": lambda: fused_adamw_stats_buckets(pb, gb, mb, vb, scal,
                                                                    **hyper),
             "fused_stats": lambda: fused_stats_buckets(mb, gb)}
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
    for k, (per_bucket, plain_tail) in tails.items():
        nbytes, flops = per_elem[k]
        # the redesigned kernels: the one list call (ms) against the earlier
        # calling pattern, one call a bucket (per_bucket_ms), and the
        # library, in turns; the others run one call a tensor on their path
        fns = {"ms": lists.get(k, per_bucket), "library_ms": library[k]}
        if k in lists:
            fns["per_bucket_ms"] = per_bucket
        timed[k] = {key: [] for key in fns}
        for order in (list(fns), list(fns)[::-1]):
            for key in order:
                timed[k][key].append(cuda_ms(fns[key], 5))
        timed[k].update(plain_ms=[cuda_ms(plain_tail, 3), cuda_ms(plain_tail, 3)],
                        bound_bytes_ms=nbytes * n_total / bw * 1e3,
                        bound_ops_ms=flops * n_total / F32_FLOPS * 1e3)
    # the FSDP path's AdamW tail: one rank's 1/2 shard of every bucket
    shards = [tuple(x[:x.numel() // 2] for x in b) for b in bufs]
    sharded = {"per_bucket_ms": lambda: [fused_adamw_stats(p, g, m, v, scal, **hyper)
                                         for p, g, m, v in shards],
               "ms": lambda: fused_adamw_stats_buckets(*zip(*shards), scal, **hyper)}
    sharded_ms = {k: [cuda_ms(fn, 5) for _ in range(2)] for k, fn in sharded.items()}
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
    # rmsnorm and flash_attention: the error at prefill's shapes, f32, as
    # the other kernels' at the main path's (the sweeps print their own)
    serve_timed = time_serving_kernels(dev, bw)
    err.update({k: t["max_abs_err"] for k, t in serve_timed.items()})
    timed.update(serve_timed)
    # the share of the byte bound each streaming loop reaches on one bucket
    t_big["fused_adamw_stats_share"] = t_big["adamw_bound_ms"] / t_big["fused_adamw_stats_ms"]
    t_big["fused_stats_share"] = t_big["stats_bound_ms"] / t_big["fused_stats_ms"]
    say("time", nvidia_smi=smi, elements=n_total, buckets=len(sizes), kernels=timed,
        sharded_fused_adamw_stats={**sharded_ms,
                                   "elements": sum(x[0].numel() for x in shards),
                                   "bound_ms": 28 * n_total / 2 / bw * 1e3},
        largest_bucket=t_big, max_abs_err=err)
    del bufs, pb, gb, mb, vb, p, g, m, v, lib_params, lib_opt, big_opt, shards
    gc.collect()
    torch.cuda.empty_cache()
    say("time-tail", nvidia_smi=smi, **time_tail(dev, sizes))

    # the training surface beyond the main path: the exact estimators, mixed
    # residency, local-SGD, and crash-safe resume in both steps
    estimators(smi, dev)
    mixed_and_local(smi, ops, dev)
    resume_accum(smi, ops, layout)
    resume_fsdp(smi, fsdp_layout)
    left = child_processes()
    if left:
        raise AssertionError(f"processes the run started are still there: {left}")

    sources = {"fused_adamw_stats": "fused_adamw.cu", "fused_adamw": "fused_adamw.cu",
               "fused_stats": "fused_stats.cu", "sqdiff_norm": "fused_stats.cu",
               "rmsnorm": "rmsnorm.cu", "flash_attention": "flash_attention.cu"}
    replaces = {"fused_adamw_stats": "src/repro/kernels/fused_adamw.py:107",
                "fused_adamw": "src/repro/kernels/fused_adamw.py:77",
                "fused_stats": "src/repro/kernels/fused_stats.py:35",
                "sqdiff_norm": "src/repro/kernels/sqdiff_norm.py:29",
                "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
                "flash_attention": "src/repro/kernels/flash_attention.py:88"}
    # launches: the FSDP main path's run (both ranks) for the flat kernels,
    # the tree run of phase 5 (both ranks, on the card) for the per-tensor
    # ones, serving's path (prefill, run_serving, continuous) for the rest
    path_launches = {**fsdp_launches, **tree_launches,
                     "rmsnorm": serve_launches["rmsnorm"],
                     "flash_attention": serve_launches["flash_attention"]}
    entries = []
    for k, t in timed.items():
        # the operations each kernel does, at their type's rate: flash's
        # are TF32 products on the tensor cores
        ops_ms = t.get("bound_tc_ms", t["bound_ops_ms"])
        bound = max(t["bound_bytes_ms"], ops_ms)
        entries.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[k]}",
            "replaces": replaces[k], "launches": path_launches[k],
            "max_abs_err": err[k], "ms": min(t["ms"]), "plain_ms": min(t["plain_ms"]),
            "bound_ms": bound,
            "bound_by": "bytes" if t["bound_bytes_ms"] >= ops_ms else "operations",
            "library_ms": min(t["library_ms"])})
    say("total", seconds=round(time.time() - t_start, 3))
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
