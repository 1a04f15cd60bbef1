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
              (openllama-3b's), 128, 200 and 256 (O in two halves,
              recurrentgemma's), causal or not, window 0/100, softcap
              0/30, f32 and bf16; tolerances printed and asserted.
   archs    — every registered config at full width, depth cut
              (ARCH_LAYERS: 1 layer for the dense Llama family; gemma2 one
              local and one global layer, 2 312 151 552 parameters;
              nemotron-4 2 layers; phi3-mini its full 32; dbrx 2 MoE
              layers, 7 751 331 840; deepseek-v2 its dense MLA prefix layer
              and one MLA + MoE layer; mamba2 its full 48 SSD layers;
              recurrentgemma its 2 RG-LRU prefix layers and one (rglru,
              rglru, local) repeat, 2 174 922 752; whisper its 6 decoder
              and 6 encoder layers; internvl2 its full 24), whisper's
              encoder frames and internvl2's patch embeddings drawn from a
              seed: the forward with grad mode off (training's eval loss;
              its flash and rmsnorm launches as `forward_kernel_launches`
              computes them from the config) against the plain forward,
              prefill against the same tokens streamed through decode
              (MoE at a capacity where no pair drops; whisper's cross
              caches filled from the same frames; internvl2 from a
              prefill over its prefix and half the text), the same stream
              once more through the serving rung's decode step captured as
              a CUDA graph (`GraphedDecode`: its greedy tokens equal to the
              eager step's at every step), and a long
              prefill at the published capacity (2 x 2048; gemma2 and
              recurrentgemma one prompt of 8192, beyond their 4096 and
              2048 windows; whisper 448 decoder tokens over 1500 frames;
              internvl2 256 prefix and 1792 text tokens), three runs
              timed, with its launches and peak memory.  Each model is
              freed before the next; then rmsnorm and flash_attention
              against their plain versions at every shape and option that
              long prefill gave them (gemma2's window 4096 and softcap 50
              at t 8192, phi3's head dim 96, 48/8 heads at d 128, MLA's
              norms at 512 and 1536, recurrentgemma's head dim 256 with
              MQA 16/1 and window 2048, whisper's non-causal encoder and
              cross-attention at t 448 over s 1500, internvl2's 14/2;
              inputs from a seed, SERVE_TOL), and gemma2's flash calls
              once more with q scaled to |logit| 50, held against f64 at
              SERVE_TOL, the kernel's and the plain version's errors
              against f64 printed.  Last, flash at recurrentgemma's
              local layer timed beside its plain version and
              F.scaled_dot_product_attention in f32.
   moe      — the dbrx and deepseek-v2 smoke configs: two identical
              forward and backward passes give bit-identical gradients;
              then 4 ACCUM-NORM steps of deepseek-v2 smoke through
              `run_training` on the card and on the CPU from the same
              parameters: the batch trajectory equal, losses and var_l1
              within REF_RTOL, one `fused_adamw_stats` a step per dtype
              group.
4. ref      — two ACCUM-NORM steps of the microllama smoke config on the
              card (kernels) and on the CPU (plain versions) from the same
              parameters; the metrics must agree.
5. fsdp-ref — two FSDP-Norm steps of the same smoke config with 2 gloo
              ranks, flat/flat and tree/tree (`AdamWConfig(use_kernel=True)`),
              on the card and on the CPU; the metrics must agree.  In the
              tree run each rank also computes the statistic from its real
              g_j and g through the `sqdiff_norm` kernel and through the
              plain `tree_sqdiff`, which must agree.  This is the path of
              `fused_adamw` and `sqdiff_norm`, the tree routes over every
              leaf: each rank's launch counts start at 0 and must be one a
              call per dtype group after it (`fused_adamw` a step, the
              statistic's `sqdiff_norm` once); the bucket-table cache's
              builds and hits are printed.
   serve-ref — llama3.2-1b at full width and 2 layers, the same
              parameters on the card and on the CPU: prefill's last-token
              logits and caches, 8 `decode_step`s at per-row positions
              (logits and caches), and `run_serving`'s greedy tokens
              (batch 2, prompt 16, gen 8) must agree, the card's through
              its CUDA graph and through the eager step alike.
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
   mesh     — the model axis: `run_training` of full-width microllama-300m
              (MESH_LAYERS of its 12 layers, seq 512, 8 sequences a step as
              2 microbatches of 4, 3 steps, an eval at step 3) on gloo
              ranks sharing the card: FSDP-Norm flat/flat and tree/tree on
              a 2 x 2 grid (4 ranks, TP over 2) and on 2 x 1 — loss,
              var_l1 and grad_sqnorm within MESH_RTOL, the final params by
              the per-entry share; the tree runs take the opt-in tree
              routes (`AdamWConfig(use_kernel=True)`, `sqdiff_fn=`), and
              the 2 x 2 one, checkpointed at step 2, is resumed on the same
              grid, bit-identical (metrics, params, the step-3
              checkpoint); ACCUM-NORM flat at J = 2 against J = 1, var_l1
              at J times.  Step ms, peak memory and TP all-reduce seconds a
              step of every rank; each rank's launches (flat: one
              `fused_stats` and `fused_adamw_stats` a step per dtype group;
              tree: one `fused_adamw` and `sqdiff_norm` a step; the eval's
              flash on 8 local heads of 16 and its rmsnorms), and every
              kernel held against its plain version at the shapes the
              phase gave it.  `python3 chip_smoke.py
              mesh [layers]` runs the device, build and this phase alone.
   mesh-kinds — the MoE, MLA, SSD and RG-LRU layers on the model axis,
              gloo ranks sharing the card: (a) one full-width block of each
              (KINDS_BLOCKS: dbrx's attention and MoE, d 6144, 16 experts of
              10752, top-4; deepseek-v2's MLA, 128 heads at kv_lora 512, and
              MoE, 160 experts of 1536 and 2 shared; mamba2-370m's SSD;
              recurrentgemma-9b's RG-LRU at 511 tokens, which the axis does
              not divide; one whisper-base encoder layer over its 1500
              frames), tokens from a seed, MoE at a capacity where no pair
              drops, on 2 ranks against the same block whole (each rank
              runs it in turn first), tensor-parallel and under sequence
              parallelism (each rank's rows of the sequence): output, dx and
              every leaf's gradient within KINDS_RTOL; (b) `run_training` at full
              width, depth cut (KINDS_LAYERS): mamba2-370m FSDP-Norm
              flat/flat and stats flat with params tree on 2 x 2 against
              2 x 1, recurrentgemma-9b FSDP-Norm tree/tree on 1 x 2 against
              1 x 1 (flash on 8 local q heads of 16 at d 256 in its eval);
              metrics within MESH_RTOL, params by the per-entry share, each
              rank's launches, step ms, peak memory and TP seconds, and
              every kernel against its plain version at the phase's shapes.
              dbrx and deepseek-v2 train on the grid at smoke width only
              (`mesh_kinds_phase` gives the memory).  `python3 chip_smoke.py
              mesh-kinds [layers]` runs the device, build and this phase
              alone.
   seqpar   — sequence parallelism in the FSDP-Norm step, gloo ranks
              sharing the card: full-width microllama-300m (SEQPAR_LAYERS
              of its 12 layers, seq 512, 8 sequences a step, 3 steps),
              `make_fsdp_norm_step` flat/flat on 1 x 2 and 2 x 2 with
              `sequence_parallel` off and on from the same seed-0
              parameters (run by phase mesh's rank groups after their own
              runs, the ranks warm): loss, var_l1 and grad_sqnorm within
              MESH_RTOL, the final params by the per-entry share; peak
              memory, step ms, TP calls and host seconds (the
              reduce-scatters and all-gathers of the stream among them) of
              every rank, gloo's `reduce_scatter_tensor` on CUDA tensors,
              each rank's `fused_stats` and `fused_adamw_stats` launches
              (one a step per dtype group), both held against their plain
              versions at the phase's shapes.  The layer kinds' blocks under
              sequence parallelism are phase mesh-kinds' (a), the dry-run's
              `--seqpar` phase dryrun's (c).  `python3 chip_smoke.py seqpar
              [layers]` runs the device, build and this phase alone.
   serve    — serving's main path, full-width llama3.2-1b (16 layers):
              `make_prefill` at 4 x 2048 tokens (launch counts 0 just
              before, exactly 16 flash_attention and 33 rmsnorm just after;
              its last-token logits and caches held against the same tokens
              streamed through `decode_step`), `run_serving` (batch 8,
              prompt 128, gen 64) through its CUDA graph and through the
              eager step, in turns (graph, eager, eager, graph): the same
              tokens, decode ms a step side by side, rmsnorm launches 33 a
              step plus the graph's one warm-up run; and
              `run_continuous_serving` (8 slots, prompt 16, gen 32, 60 load
              steps, arrivals 0.5/step and a burst of 5 every 20), every
              rung a captured graph: rmsnorm launches 33 x (steps +
              builds), the steady-state probe a hit with no new build; the
              continuous run's figures for its load window alone beside
              the reference's keys, which also count the probe.
   dryrun   — the dry-run (`python -m repro_torch.launch.dryrun`: one rank's
              step traced on fake CUDA tensors, the kernels as custom ops
              with fake implementations), held against this run: (a) one
              ACCUM-NORM flat/flat step of full-width microllama-300m at
              phase train's last batch, run twice on the card, the trace's
              peak within DRYRUN_MEM_RTOL of the second run's
              max_memory_allocated and its kernel calls equal to the
              launches; (b) every config's prefill at ARCH_LAYERS and
              ARCH_PREFILL, its flash_attention and rmsnorm calls equal to
              `forward_kernel_launches`, and llama3.2-1b's 16-layer 4 x 2048
              prefill's FLOPs equal to `prefill_gemm_flops` plus its 16
              flash calls', exactly; (c) llama3.2-1b decode_32k and
              microllama-300m train_4k (FSDP-Norm flat, with and without
              `--seqpar`) on a fake 16 x 16 group of 256 ranks: memory,
              FLOPs, collective bytes by kind, the roofline terms and the
              bottleneck, the rank's parameter bytes equal to its specs'
              slices; with `--seqpar` reduce-scatters on the model groups
              of 16 and a lower peak than without.  `python3 chip_smoke.py
              dryrun` runs the device, build and this phase alone.
   serve-mesh — serving on a data x model grid of gloo ranks sharing the
              card, full-width llama3.2-1b (SM_LAYERS of its 16 layers,
              f32, seed-0 weights): a 4 x 2048 `make_prefill` on 1 x 2 (a
              flash launch a layer a rank on 16 of the 32 heads, 2 rmsnorm
              a layer and the final one), its
              logits and gathered caches within SERVE_REL (max abs error
              over the largest magnitude) of the one-process prefill; `run_serving` (batch 8, prompt 128, gen
              64) on 2 x 1 (each rank's rows a CUDA graph), 1 x 2 and 2 x 2
              (eager: a model axis's gloo all-reduces cannot be captured),
              every step's logits (the eager run's own; a graph run's
              tokens teacher-forced through the grid's eager step) within
              SERVE_REL of the one-process step on the same tokens,
              the greedy tokens equal wherever the one-process top-2 margin
              exceeds twice that, decode ms a step printed beside the
              one-process run's; `run_continuous_serving` (CONT_JOB) on
              2 x 1 and 2 x 2: the rung trace, completed requests and
              engine counters equal to the one-process run's, the probe a
              hit, the load window's req/s and p50/p99 printed; one
              full-width block of every other layer kind on 1 x 2
              (SM_PIECES: dbrx's attention and MoE, deepseek-v2's MLA and
              MoE with a cache of 8192 whose latents lie over the model
              axis, mamba2's SSD, recurrentgemma's RG-LRU and its MQA local
              layer at head dim 256, gemma2's softcapped global layer): a
              2 x 512 prefill and 8 decode steps at per-row positions,
              outputs and caches within SERVE_MESH_REL of the block run
              whole.  The grid runs' launches go into the kernels line, and
              flash and rmsnorm are held against their plain versions at
              the shapes the phase gave them.  `python3 chip_smoke.py
              serve-mesh` runs the device, build and this phase alone.
8. time     — each kernel, its plain version and the nearest library call
              at the main path's shapes (all buckets of the layout; for
              rmsnorm and flash_attention prefill's shapes), timed with
              CUDA events, beside the least time the card could take;
              `fused_adamw_stats` and `fused_stats` as one list call, and
              `fused_adamw` and `sqdiff_norm` as their one-launch tree
              routes over the 98 tensors (`ops.fused_adamw_tree`, lr from
              the host; `ops.sqdiff_norm_tree`), each also in the earlier
              pattern of one call a bucket, in turns with the library call;
              the list calls, the tree routes (twice: the same bits),
              rmsnorm and flash_attention also held against their plain
              versions there, and the bucket-table cache's builds and hits
              printed; flash_attention
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
   coord    — `python -m repro_torch.launch.train --coord file
              --aot-warmup --compile-cache DIR`, smoke llama3.2-1b,
              ACCUM-NORM flat/flat over a stagewise 4 -> 8 increase: two
              ranks on the card, the increase a warmed transition hit on
              both; a second job over the same DIR loads the kernel
              library from disk (disk_cache_hits > 0, no nvcc: the
              libraries keep their inodes); the dead-rank survivor (rank 1
              SIGKILLed at step 3, rank 0 fails with a CoordinationError
              naming it after checkpointing step 6).
   resume-accum — full-width microllama-300m (RESUME_ACCUM_LAYERS of its 12
              layers), ACCUM-NORM, flat stats and params: an uninterrupted
              6-step run; the same job through the train CLI's `main` (in
              a child cut to the same depth) with a checkpoint every 2 steps, killed by the fault harness
              (SIGKILL) at the top of step 5; `run_training(resume=True)`
              to step 6.  Losses, batches, var_l1, eval losses and the
              step-6 checkpoints (params, moments, count, controller state)
              must be bit-identical; the resumed path's launch counts (one
              `fused_adamw_stats` a step per dtype group; one eval's flash
              and rmsnorm) are asserted; free space, checkpoint bytes and
              the save and restore times are printed, and the checkpoint
              directory is removed, passed or failed.
   resume-fsdp — the same with FSDP-Norm on 2 gloo ranks sharing the card
              (RESUME_FSDP_LAYERS of 12): 6 steps; 4 steps with checkpoints, then a fresh
              `run_training(resume=True)` to 6, in one process group; the
              flat shards are gathered on save and re-split on resume.

Every process the run started (nvcc, the ranks and the resource tracker
that spawning them starts) must have ended by then; a child still there
fails the run.  Then one JSON line describing the kernels, the nvidia-smi
line, and the final line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of the repository beside it, it fails before printing any
result.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
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
# phase archs: depth kept at full width (default 1: the dense Llama family);
# gemma2 one local and one global layer, deepseek-v2 its dense prefix layer
# and one MoE layer, phi3-mini, mamba2, whisper (6 decoder and its 6
# encoder layers) and internvl2 their full depth, recurrentgemma its 2 RG-LRU
# prefix layers and one (rglru, rglru, local) repeat
ARCH_LAYERS = {"gemma2-27b": 2, "nemotron-4-15b": 2, "phi3-mini-3.8b": 32,
               "dbrx-132b": 2, "deepseek-v2-236b": 2, "mamba2-370m": 48,
               "recurrentgemma-9b": 5, "whisper-base": 6, "internvl2-1b": 24}
# (batch, text tokens): whisper's 448 decoder tokens over its 1500 frames,
# internvl2's 1792 text tokens behind its 256-token vision prefix (2048),
# gemma2's and recurrentgemma's one prompt of 8192, beyond their windows
ARCH_PREFILL = {"gemma2-27b": (1, 8192), "nemotron-4-15b": (2, 2048),
                "phi3-mini-3.8b": (2, 2048), "dbrx-132b": (2, 2048),
                "deepseek-v2-236b": (2, 2048), "mamba2-370m": (2, 2048),
                "recurrentgemma-9b": (1, 8192), "whisper-base": (2, 448),
                "internvl2-1b": (2, 1792)}
ARCH_CHECK_LEN = 64       # prefill vs streamed decode (an SSD config: its chunk)
# recurrentgemma's local attention: (b, t, s, h, kvh, d), causal, window
FLASH_D256 = ((1, 8192, 8192, 16, 1, 256), 2048)
MOE_SMOKE = ("dbrx-132b", "deepseek-v2-236b")
MOE_TRAIN_JOB = dict(arch="deepseek-v2-236b", smoke=True, schedule="adaptive",
                     step_impl="accum_norm", stats_impl="flat", params_impl="flat",
                     seq_len=64, base_global_batch=4, max_global_batch=32,
                     base_micro_batch=2, max_micro_batch=4, base_accum=2, steps=4,
                     eval_every=0)
KERNELS = ("fused_adamw_stats", "fused_adamw", "fused_stats", "sqdiff_norm",
           "rmsnorm", "flash_attention")
# phase mesh: the model axis, full-width microllama-300m on gloo ranks that
# share the card; a constant plan of 8 a step (M = 2 microbatches of 4)
MESH_LAYERS = 2           # of 12: at full depth the phase took 234 s, at 4 105 s (PERF.md §4, §6)
MESH_JOB = dict(arch="microllama-300m", smoke=False, schedule="constant",
                step_impl="fsdp_norm", stats_impl="flat", params_impl="flat",
                seq_len=512, base_global_batch=8, max_global_batch=8,
                base_micro_batch=2, max_micro_batch=2, base_accum=2, steps=3,
                eval_every=3, eval_batches=1, device="cuda", dist_backend="gloo")
MESH_RTOL = 1e-5          # loss, var_l1, grad_sqnorm across grids
MESH_SHARE = 2.5e-2       # params after step 3: entries past rtol 1e-5 / atol 1e-7
# phase mesh-kinds: the MoE, MLA, SSD and RG-LRU layers on the model axis.
# (a) one block of each at full width on 2 ranks against whole, tensor-
# parallel and sequence-parallel: name: (arch, kind, MoE feed-forward,
# (batch, tokens)); recurrentgemma's 511 tokens do not divide the axis
# (zero-padded to 512 under sequence parallelism, trimmed at every gather)
KINDS_RTOL = 1e-5         # max abs error over the largest magnitude, f32
KINDS_BLOCKS = {
    "dbrx-attn-moe": ("dbrx-132b", "attn", True, (2, 512)),
    "deepseek-v2-mla-moe": ("deepseek-v2-236b", "mla", True, (2, 512)),
    "mamba2-ssd": ("mamba2-370m", "ssd", False, (2, 512)),
    "recurrentgemma-rglru": ("recurrentgemma-9b", "rglru", False, (2, 511)),
    "whisper-encoder": ("whisper-base", "attn", False, (2, 1500))}
# (b) training on the grid at full width, depth cut: mamba2-370m 2 of its 48
# SSD layers (4 until the whole run reached 986 s, PERF.md §4); recurrentgemma-9b
# its 2 RG-LRU prefix layers and one (rglru, rglru, local) repeat
KINDS_LAYERS = {"mamba2-370m": 2, "recurrentgemma-9b": 5}
KINDS_JOB = dict(MESH_JOB, arch="mamba2-370m")
# phase seqpar: sequence parallelism in the FSDP-Norm step, full-width
# microllama-300m, depth cut as phase mesh's, on 1 x 2 and 2 x 2
SEQPAR_LAYERS = 2         # of 12
SEQPAR_STEPS = 3
SEQPAR_SEQ = 512
SEQPAR_GRIDS = ((1, 2), (2, 2))
# phase serve-mesh: serving on a data x model grid of gloo ranks sharing the
# card, full-width llama3.2-1b (SM_LAYERS of 16, f32, seed-0 weights), and one
# block of every other layer kind at full width on 1 x 2
# a grid against one process on the card: the whole model's
# logits and caches at SERVE_REL (the serving phases' whole-model
# tolerance, max abs error over the largest magnitude); one block of a
# layer kind (the pieces) at 1e-5 of its largest magnitude
SERVE_MESH_REL = 1e-5
SM_PIECES = {  # name: (arch, kind, MoE feed-forward)
    "dbrx-moe": ("dbrx-132b", "attn", True),
    "deepseek-v2-mla-moe": ("deepseek-v2-236b", "mla", True),
    "mamba2-ssd": ("mamba2-370m", "ssd", False),
    "recurrentgemma-rglru": ("recurrentgemma-9b", "rglru", False),
    "recurrentgemma-local": ("recurrentgemma-9b", "local", False),
    "gemma2-global": ("gemma2-27b", "attn", False)}
SM_PIECE_TOKENS = (2, 512)    # each piece's prefill; then SM_PIECE_STEPS decode steps
SM_PIECE_STEPS = 8
# the pieces' caches: MLA's at 8192 positions, its latents over the model axis
SM_PIECE_CACHE = {"deepseek-v2-mla-moe": 8192}
SM_PIECE_CACHE_DEFAULT = 2048
SM_TIMEOUT_S = 400        # a group of ranks that has not ended by then is stopped
# llama3.2-1b's depth on the grid: 4 of 16 layers since the whole run took
# 1148.2 s on a slow host at 16 (PERF.md §6)
SM_LAYERS = 4
# phase dryrun: the trace's peak against the card's max_memory_allocated for
# one ACCUM-NORM step, and two production combinations on a fake 16 x 16
DRYRUN_MEM_RTOL = 0.10
# (global batch, accumulation steps) of phase train's last step, for the
# phase run alone
DRYRUN_PLAN = (32, 4)
# (arch, shape, seqpar)
DRYRUN_COMBOS = (("llama3.2-1b", "decode_32k", False), ("microllama-300m", "train_4k", False),
                 ("microllama-300m", "train_4k", True))


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
    from repro_torch.kernels.buckets import TABLES
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
            tables = (TABLES.builds, TABLES.hits)
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
                                  "table_builds": TABLES.builds - tables[0],
                                  "table_hits": TABLES.hits - tables[1],
                                  "param_dtypes": len({x.dtype for x in
                                                       tree_flatten(params)[0]}),
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
    """Over every layer whose prefill collects a cache (a recurrent layer's
    is None, as in the reference)."""
    return max((rel_err(x[k], y[k]) for x, y in zip(a, b) if x is not None for k in y),
               default=0.0)


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
    # 33: 4-byte copies, bf16 plain loads; 200 and 256: O in two halves
    for d in (16, 32, 33, 64, 100, 128, 200, 256):
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


def prefill_gemm_flops(cfg, b: int, t: int) -> int:
    """Floating-point operations of the weight products of one prefill of
    b x t tokens (2 a multiply-add): every layer's projections (RG-LRU's
    branches, gates and output; SSD's in and out projections), dense MLP
    or — at the capacity the config dispatches at — router, experts and
    shared experts, an encoder's layers over its frames and the decoder's
    cross-attention projections, and the last token's logits.  The
    attention products (flash, MLA's einsums) and SSD's chunked products
    are not counted."""
    from repro_torch.models.blocks import has_mlp
    from repro_torch.models.moe import _capacity
    from repro_torch.models.transformer import layer_plan

    d, n = cfg.d_model, b * t
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mlp = (3 if cfg.mlp_kind in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    macs = b * cfg.vocab_size * d                        # last-token logits
    if cfg.encoder is not None:
        nf = b * cfg.encoder.num_frames
        macs += cfg.encoder.num_layers * nf * (2 * d * q + 2 * d * kv + mlp)
        # each decoder layer's cross-attention: q and out over the tokens,
        # k and v over the frames
        macs += cfg.num_layers * (n * 2 * d * q + nf * 2 * d * kv)
    for kind, moe_layer in layer_plan(cfg):
        if kind == "rglru":
            w = cfg.rglru.lru_width or d
            macs += n * (3 * d * w + 2 * w * w)
        elif kind == "ssd":
            s = cfg.ssm
            di = s.d_inner(d)
            macs += n * (d * (2 * di + 2 * s.state_dim + s.num_heads(d)) + di * d)
        elif kind == "mla":
            m, h = cfg.mla, cfg.num_heads
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            q = (d * m.q_lora_rank + m.q_lora_rank * h * qk if m.q_lora_rank
                 else d * h * qk)
            macs += n * (q + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                         + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                         + h * m.v_head_dim * d)
        else:
            macs += n * (2 * d * q + 2 * d * kv)
        if moe_layer:
            m = cfg.moe
            slots = b * m.num_experts * _capacity(t, m, m.capacity_factor)
            macs += n * d * m.num_experts + slots * 3 * d * m.d_expert
            macs += n * 3 * d * m.num_shared_experts * m.shared_d_expert
        elif has_mlp(cfg, kind):
            macs += n * mlp
    return 2 * macs


def forward_kernel_launches(cfg) -> dict:
    """Launches of the forward-only kernels in one forward of `cfg` on the
    card with grad mode off (prefill, the eval loss): `flash_attention` once
    an attention layer (MLA attends in plain PyTorch; RG-LRU and SSD layers
    are recurrences), once an encoder layer and once a decoder layer's
    cross-attention; `rmsnorm` once a norm where the model's norms are
    RMSNorm (LayerNorm has no kernel) — a layer's pre-norm, its MLP norm
    (an SSD layer has no MLP), their post-norms, a decoder layer's
    cross-attention norm, every encoder layer's norms and the final norms
    — plus MLA's `q_norm` and `kv_norm`, which are RMSNorm in every config.
    A decode step runs the same decoder rmsnorms and, for an
    encoder-decoder, its cross-attention flash calls.  Counted from the
    config alone, so that a model that stops reaching a kernel fails the
    phase; `tests/test_torch_archs.py` holds it against the calls a
    forward makes."""
    from repro_torch.models.blocks import has_mlp
    from repro_torch.models.config import ATTN, LOCAL_ATTN, MLA_ATTN
    from repro_torch.models.transformer import layer_kinds

    rms = cfg.norm_kind == "rmsnorm"
    cross = cfg.encoder is not None

    def layer_norms(kind):
        n = 1 + has_mlp(cfg, kind)
        return 2 * n if cfg.post_attn_norm else n

    flash, norms = 0, rms                                  # the final norm
    for kind in layer_kinds(cfg):
        flash += (kind in (ATTN, LOCAL_ATTN)) + cross
        norms += (layer_norms(kind) + cross) * rms
        if kind == MLA_ATTN:
            norms += 1 + bool(cfg.mla.q_lora_rank)
    if cross:
        flash += cfg.encoder.num_layers
        norms += (cfg.encoder.num_layers * layer_norms(ATTN) + 1) * rms
    return {"flash_attention": flash, "rmsnorm": norms}


@contextlib.contextmanager
def recorded_kernel_calls(ops):
    """Within the block, the distinct shapes and options of the model's
    `ops.flash_attention` and `ops.rmsnorm` calls, each once, in order (the
    caller's `plain` code, run off the card only, is no option).  The calls
    go through unchanged, so the wrappers count as ever."""
    calls = {"flash_attention": [], "rmsnorm": []}
    real_flash, real_norm = ops.flash_attention, ops.rmsnorm

    def note(kernel, key):
        if key not in calls[kernel]:
            calls[kernel].append(key)

    def flash(q, k, v, plain=None, **kw):
        note("flash_attention", (tuple(q.shape), tuple(k.shape), q.dtype,
                                 tuple(sorted(kw.items()))))
        return real_flash(q, k, v, plain=plain, **kw)

    def norm(x, scale, eps=1e-6, plain=None):
        note("rmsnorm", (tuple(x.shape), x.dtype, scale.dtype, eps))
        return real_norm(x, scale, eps, plain=plain)

    ops.flash_attention, ops.rmsnorm = flash, norm
    try:
        yield calls
    finally:
        ops.flash_attention, ops.rmsnorm = real_flash, real_norm


def by_kv_head(fn, q, k, v):
    """`fn` over one kv head and its group of q heads at a time, the
    results joined over heads: bounds the (t, s) logits of a long prompt."""
    g = q.shape[2] // k.shape[2]
    return torch.cat([fn(q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1])
                      for j in range(k.shape[2])], dim=2)


def check_path_shapes(calls, dev) -> dict:
    """The kernels against their plain versions at the shapes and options
    the main path gave them (`recorded_kernel_calls` of a long prefill and
    of `prefill_vs_decode`'s prefill and decode steps), on inputs drawn
    from a seed, at SERVE_TOL.  An f32 flash call with a
    softcap is run again with q scaled so that the largest |q.k|/sqrt(d)
    equals the softcap (gemma2-27b's 50, which its logits may reach) and
    held against the same attention in f64 at SERVE_TOL (there the plain
    f32 version's own error nears that tolerance); the kernel's and the
    plain version's errors against f64 are printed beside each other.
    Returns each kernel's max abs error against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    err = {"rmsnorm": 0.0, "flash_attention": 0.0}
    tol = lambda dt, k: SERVE_TOL[k] if dt == torch.float32 else SERVE_TOL["bf16"]
    abs_err = lambda a, b: float((a.double() - b.double()).abs().max())
    for i, (shape, xd, sd, eps) in enumerate(calls["rmsnorm"]):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(shape, device=dev, generator=gen).to(xd)
        scale = (1 + 0.1 * torch.randn(shape[-1], device=dev, generator=gen)).to(sd)
        with torch.inference_mode():
            got = rmsnorm(x, scale, eps)
        want = ref.rmsnorm_ref(x, scale, eps)
        torch.testing.assert_close(got, want, **tol(xd, "rmsnorm_f32"))
        err["rmsnorm"] = max(err["rmsnorm"], abs_err(got, want))
        say("archs", kernel="rmsnorm", shape=list(shape), x=str(xd), scale=str(sd),
            max_abs_err=abs_err(got, want))
        del x, got, want
    for i, (qs, ks, dt, kw) in enumerate(calls["flash_attention"]):
        kw = dict(kw)
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        q, k, v = (torch.randn(s, device=dev, generator=gen) for s in (qs, ks, ks))
        plain = lambda q, k, v: ref.flash_attention_ref(q, k, v, **kw)
        with torch.inference_mode():
            got = flash_attention(q.to(dt), k.to(dt), v.to(dt), **kw)
            want = by_kv_head(plain, q.to(dt), k.to(dt), v.to(dt))
        torch.testing.assert_close(got, want, **tol(dt, "flash_f32"))
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        row = dict(kernel="flash_attention", q=list(qs), k=list(ks), dtype=str(dt),
                   **kw, max_abs_err=abs_err(got, want))
        del got, want
        if dt == torch.float32 and kw.get("softcap", 0.0) > 0:
            g = qs[2] // ks[2]
            top = max(float(torch.einsum("bthd,bsd->bhts", q[:, :, j * g:(j + 1) * g],
                                         k[:, :, j]).abs().max())
                      for j in range(ks[2])) / qs[-1] ** 0.5
            q = q * (kw["softcap"] / top)
            exact = lambda q, k, v: ref.flash_attention_ref(
                q.double(), k.double(), v.double(), **kw)
            with torch.inference_mode():
                got = flash_attention(q, k, v, **kw)
                want = by_kv_head(plain, q, k, v)
                f64 = by_kv_head(exact, q, k, v)
            row["at_softcap_logit"] = {
                "max_logit": kw["softcap"], "kernel_vs_plain": abs_err(got, want),
                "kernel_vs_f64": abs_err(got, f64), "plain_vs_f64": abs_err(want, f64),
                "limit": SERVE_TOL["flash_f32"]}
        say("archs", **row)
        if "at_softcap_logit" in row:
            torch.testing.assert_close(got.double(), f64, **SERVE_TOL["flash_f32"])
            del got, want, f64
        del q, k, v
    return err


def frontend_inputs(cfg, b: int, gen, dev) -> dict:
    """A stub frontend's inputs for b rows, standard normal from `gen`:
    an audio config's encoder frames (b, num_frames, d), a vision config's
    patch embeddings (b, num_prefix_tokens, d); {} for none."""
    if cfg.frontend.kind == "audio_stub":
        shape = (b, cfg.encoder.num_frames, cfg.d_model)
        return {"frames": torch.randn(shape, device=dev, generator=gen)}
    if cfg.frontend.kind == "vision_stub":
        shape = (b, cfg.frontend.num_prefix_tokens, cfg.d_model)
        return {"patch_embeds": torch.randn(shape, device=dev, generator=gen)}
    return {}


def fill_cross_cache(params, cache: list, frames, cfg) -> list:
    """Encode `frames` (b, num_frames, d) and write every decoder layer's
    cross-attention k and v over them into the decode cache `cache`, in
    place (the reference's tests build the same cross caches with `encode`
    and `precompute_cross_kv`).  Returns the cache."""
    from repro_torch.models.attention import precompute_cross_kv
    from repro_torch.models.transformer import encode

    enc = encode(params, frames.to(cfg.act_dtype), cfg)
    for p, c in zip(params["layers"], cache):
        kv = precompute_cross_kv(p["cross_attn"], enc)
        c["cross_k"].copy_(kv["k"])
        c["cross_v"].copy_(kv["v"])
    return cache


def prefill_vs_decode(model, params, toks, front, dev) -> dict:
    """Prefill over `toks` (and the frontend inputs `front`) against the
    same tokens streamed through decode: the last logits and every cache
    the prefill collects, relative errors.  An encoder-decoder's decode
    cache gets its cross k and v from the same frames first
    (`fill_cross_cache`); a vision config's decode takes tokens only, so a
    prefill over the prefix and the first half of the text starts its
    cache and the second half streams.  The same stream then runs through
    the serving rung's decode step captured as a CUDA graph
    (`GraphedDecode`) from a copy of the starting cache: its greedy token
    must equal the eager step's at every step, and its final cache's
    relative error from the eager one is reported (`graph_caches`)."""
    from repro_torch.distributed.serve_step import (
        GraphedDecode, make_decode_step, make_prefill, make_slot_decode_step)

    b, n = toks.shape
    logits, caches = make_prefill(model)(params, {"tokens": toks, **front})
    npfx, start = 0, 0
    if "patch_embeds" in front:
        npfx, start = front["patch_embeds"].shape[1], n // 2
        _, head = make_prefill(model)(params, {"tokens": toks[:, :start], **front})
        cache = model.init_cache(b, npfx + n, device=dev)
        with torch.inference_mode():
            for c, h in zip(cache, head):
                for k in c:
                    c[k][:, :npfx + start].copy_(h[k])
    else:
        cache = model.init_cache(b, n, device=dev)
        if "frames" in front:
            with torch.inference_mode():
                fill_cross_cache(params, cache, front["frames"], model.cfg)
    graph_cache = [{k: x.clone() for k, x in layer.items()} for layer in cache]
    step = make_decode_step(model)
    greedy = []
    for i in range(start, n):
        dec, cache = step(params, cache, toks[:, i], npfx + i)
        greedy.append(torch.argmax(dec, -1).to(torch.int32))
    graph = GraphedDecode(make_slot_decode_step(model, max_slots=b)(b), params,
                          graph_cache, b)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, want in zip(range(start, n), greedy):
        pos.fill_(npfx + i)
        got, _ = graph(params, graph_cache, toks[:, i], pos)
        if not torch.equal(got, want):
            raise AssertionError(f"{model.cfg.name}: the captured decode step's "
                                 f"tokens at position {npfx + i} differ from the "
                                 f"eager step's: {got.tolist()} vs {want.tolist()}")
    return {"last_logits": rel_err(logits, dec), "caches": caches_rel_err(caches, cache),
            "graph_caches": caches_rel_err(cache, graph_cache)}


def time_flash_d256(dev, bw: float) -> dict:
    """flash_attention at recurrentgemma-9b's local layer (FLASH_D256: one
    prompt of 8192, MQA 16 / 1, head dim 256, causal, window 2048), f32,
    against its plain version, and timed beside the plain version and
    `F.scaled_dot_product_attention` on the same f32 inputs (the kv head
    expanded to 16, the window as a boolean mask; timed only, the port
    never calls it), CUDA events; with the least time the card could take:
    bytes (q, k, v read once, out written once) over the memory rate, and
    the two products' operations over the visible (query, key) pairs,
    at f32's 67 TFLOP/s and as three TF32 products at 495."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import causal_mask

    (b, t, s, h, kvh, d), window = FLASH_D256
    gen = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn(b, t, h, d, device=dev, generator=gen)
    k, v = (torch.randn(b, s, kvh, d, device=dev, generator=gen) for _ in range(2))
    kw = dict(causal=True, window=window)
    pairs = sum(min(i + 1, window) for i in range(t))
    with torch.inference_mode():
        got = flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got, want, **SERVE_TOL["flash_f32"])
        err = float((got - want).abs().max())
        del got, want
        ms = [cuda_ms(lambda: flash_attention(q, k, v, **kw), 3) for _ in range(2)]
        plain_ms = [cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 1)
                    for _ in range(2)]
        qt = q.transpose(1, 2)
        kt, vt = (torch.repeat_interleave(x, h // kvh, dim=2).transpose(1, 2)
                  for x in (k, v))
        mask = causal_mask(t, s, window=window, device=dev)
        library_ms = [cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 1) for _ in range(2)]
    flops = 4 * b * h * d * pairs
    return {"shape": [b, t, s, h, kvh, d], "causal": True, "window": window,
            "dtype": "float32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "F.scaled_dot_product_attention",
            "visible_pairs": pairs,
            "bound_bytes_ms": 2 * (q.numel() + k.numel()) * 4 / bw * 1e3,
            "bound_ops_ms": flops / F32_FLOPS * 1e3,
            "bound_tc_ms": 3 * flops / TF32_FLOPS * 1e3}


@contextlib.contextmanager
def recorded_flat_calls(ops):
    """Within the block, the distinct sizes and dtypes of the training
    tail's calls over every bucket or leaf (`ops.stats_flat_buckets`,
    `ops.adamw_flat_buckets`, and the tree routes `ops.sqdiff_norm_tree`,
    `ops.fused_adamw_tree`), each once; the calls go through unchanged."""
    from repro_torch.tree import tree_leaves
    names = {"fused_stats": "stats_flat_buckets", "fused_adamw_stats": "adamw_flat_buckets",
             "sqdiff_norm": "sqdiff_norm_tree", "fused_adamw": "fused_adamw_tree"}
    calls = {k: [] for k in names}
    real = {k: getattr(ops, n) for k, n in names.items()}

    def recording(kernel):
        def call(first, *args, **kw):
            leaves = tree_leaves(first)
            key = (tuple(tuple(x.shape) for x in leaves), tuple(x.dtype for x in leaves))
            if key not in calls[kernel]:
                calls[kernel].append(key)
            return real[kernel](first, *args, **kw)
        return call

    for k, n in names.items():
        setattr(ops, n, recording(k))
    try:
        yield calls
    finally:
        for k, n in names.items():
            setattr(ops, n, real[k])


def check_flat_shapes(calls, dev) -> dict:
    """The tail's kernels over every bucket or leaf against their plain
    versions, one by one, at the shapes `recorded_flat_calls` saw, inputs
    from a seed, at phase 3's tolerances.  Returns each kernel's max abs
    error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_adamw import adamw_scalars, fused_adamw_stats_buckets
    from repro_torch.kernels.fused_stats import fused_stats_buckets

    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    sc = dict(lr=torch.tensor(3e-4, device=dev), c1=torch.tensor(1 - 0.9 ** 3, device=dev),
              c2=torch.tensor(1 - 0.95 ** 3, device=dev))
    clip = torch.tensor(0.37, device=dev)
    err = {k: 0.0 for k in calls}

    def rand(shapes, dtypes, seed, scale):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [(scale * torch.randn(sh, device=dev, generator=gen)).to(dt)
                for sh, dt in zip(shapes, dtypes)]

    def close_sum(kernel, got, want):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        err[kernel] = max(err[kernel], float((got - want).abs()))

    for i, (shapes, dtypes) in enumerate(calls["fused_stats"] + calls["sqdiff_norm"]):
        x, y = rand(shapes, dtypes, 10 * i, 1e-3), rand(shapes, dtypes, 10 * i + 1, 1e-3)
        if i < len(calls["fused_stats"]):
            dsq, ysq = fused_stats_buckets(x, y)
            want = [ref.fused_stats_ref(a, b) for a, b in zip(x, y)]
            close_sum("fused_stats", dsq, sum(w[0] for w in want))
            close_sum("fused_stats", ysq, sum(w[1] for w in want))
        else:
            close_sum("sqdiff_norm", ops.sqdiff_norm_tree(x, y),
                      sum(ref.sqdiff_norm_ref(a, b) for a, b in zip(x, y)))
        del x, y
    for i, (shapes, dtypes) in enumerate(calls["fused_adamw_stats"] + calls["fused_adamw"]):
        f32 = [torch.float32] * len(shapes)
        p, g = rand(shapes, dtypes, 10 * i + 2, 0.02), rand(shapes, f32, 10 * i + 3, 1e-3)
        m = rand(shapes, f32, 10 * i + 4, 1e-4)
        v = [x ** 2 for x in rand(shapes, f32, 10 * i + 5, 1e-3)]
        if i < len(calls["fused_adamw_stats"]):
            kernel = "fused_adamw_stats"
            want = [ref.adamw_stats_ref(*b, **sc, clip_scale=clip, **hyper)
                    for b in zip(p, g, m, v)]
            gsq = fused_adamw_stats_buckets(p, g, m, v, adamw_scalars(*sc.values(), clip, dev),
                                            **hyper)
            close_sum(kernel, gsq, sum(w[3] for w in want))
        else:
            kernel = "fused_adamw"
            want = [ref.adamw_ref(*b, **sc, **hyper) for b in zip(p, g, m, v)]
            ops.fused_adamw_tree(p, g, m, v, **sc, **hyper)
        for b, w in zip(zip(p, m, v), want):
            for got, expect in zip(b, w):
                torch.testing.assert_close(got, expect, rtol=1e-6, atol=1e-9)
                err[kernel] = max(err[kernel], float((got - expect).abs().max()))
        del p, g, m, v, want
    gc.collect()
    torch.cuda.empty_cache()
    return err


def mesh_rank(runs, layers, root):
    """The runs of phase mesh on one world size, in order, each a
    `run_training` of a TrainJob dict as this rank of the process group
    (the ranks stay up between runs), the config cut to `layers` layers when
    fewer than its own.  A run named "...-resume" first takes the step-2
    checkpoint of the run before it into a directory of its own.  Returns,
    per run, the history's step metrics and timestamps, each rank's
    launches, peak memory and TP all-reduce seconds, the whole final
    parameters on the CPU, its seconds, and the shapes of its kernel calls."""
    import functools
    import shutil
    import torch.distributed as dist
    from repro_torch.distributed import train_step as TS
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    full, adamw_cfg, stats = T.get_config, T.AdamWConfig, TS.worker_variance_stats
    if layers < full(runs[0][1]["arch"]).num_layers:
        T.get_config = lambda arch: full(arch).replace(num_layers=layers)
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = {}
    try:
        for name, job in runs:
            # the tree runs take the opt-in tree routes: the `fused_adamw`
            # update (`AdamWConfig(use_kernel=True)`) and the statistic's
            # `sqdiff_norm` (`sqdiff_fn=`)
            tree = job["params_impl"] == "tree"
            T.AdamWConfig = functools.partial(adamw_cfg, use_kernel=True) if tree else adamw_cfg
            TS.worker_variance_stats = (functools.partial(
                stats, sqdiff_fn=lambda a, b: ops.sqdiff_norm_tree(a, b)) if tree else stats)
            if name.endswith("-resume") and rank == 0:
                src = job["checkpoint_dir"].removesuffix("-resume")
                os.makedirs(job["checkpoint_dir"])
                for f in os.listdir(src):
                    if "00000002" in f:
                        shutil.copy(os.path.join(src, f), job["checkpoint_dir"])
            if dist.is_initialized():
                dist.barrier()
            # repro: allow(unfenced-timing) — whole-run span; run_training materializes host floats every step, so the wall clock cannot run ahead of device work
            t0 = time.time()
            with recorded_kernel_calls(ops) as calls, recorded_flat_calls(ops) as flat:
                hist = T.run_training(T.TrainJob(**job))
            r = {k: hist[k] for k in ("loss", "var_l1", "grad_sqnorm", "val_loss", "time",
                                      "global_batch", "samples", "ranks", "resumed_from")}
            r.update(seconds=time.time() - t0, calls=calls, flat_calls=flat,
                     final_params=[x.detach().cpu() for x in
                                   tree_leaves(hist["final_params"])])
            out[name] = r
            del hist
            gc.collect()
    finally:
        T.get_config, T.AdamWConfig, TS.worker_variance_stats = full, adamw_cfg, stats
    return out


def mesh_group_rank(jobs, layers, root):
    """A rank of one of phase mesh's groups: its runs (`mesh_rank`), then
    phase seqpar's runs on the grid of the group's size (1 x 2 on 2 ranks,
    2 x 2 on 4), the ranks already warm."""
    import torch.distributed as dist
    grid = (1, 2) if dist.get_world_size() == 2 else (2, 2)
    return mesh_rank(jobs, layers, root), seqpar_train_rank(grid, SEQPAR_LAYERS)


def mesh_agree(runs, a, b, what, dev, var_scale=1.0) -> dict:
    """Runs a and b agree: metrics at MESH_RTOL (b's var_l1 times
    var_scale) and the final parameters by the per-entry share; returns the
    largest entry error and the share past rtol 1e-5 / atol 1e-7."""
    for k in ("loss", "var_l1", "grad_sqnorm"):
        for x, y in zip(runs[a][k], runs[b][k]):
            y = y * (var_scale if k == "var_l1" else 1.0)
            if not close(x, y, MESH_RTOL):
                raise AssertionError(f"{what}: {k} {runs[a][k]} vs {runs[b][k]}")
    worst, off, n = 0.0, 0, 0
    for x, y in zip(runs[a]["final_params"], runs[b]["final_params"]):
        x, y = x.to(dev).float(), y.to(dev).float()
        d = (x - y).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-7 + 1e-5 * y.abs()).sum())
        n += y.numel()
    if worst > 1e-4 or off / n > MESH_SHARE:
        raise AssertionError(f"{what}: params max err {worst}, share {off / n}")
    return {"max_abs_err": worst, "share_past_1e-5": off / n}


def mesh_phase(smi, ops, dev) -> tuple:
    """Phase mesh: the model axis on the card (module docstring): the 2 x 2
    runs on one group of 4 ranks, the 2 x 1 runs on one of 2, J = 1 in this
    process.  Returns (each kernel's launches on the grid's main run,
    summed over its ranks; each kernel's max abs error at the shapes the
    phase gave it; phase seqpar's runs, {grid: `seqpar_train_rank`'s
    result}, which the groups of 2 and 4 ranks run after the phase's own)."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn_workers

    # repro: allow(unfenced-timing) — phase wall clock; the phase ends in host reads of its results and joined child ranks, so no device work is left in flight
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    L = MESH_LAYERS
    ck = os.path.join(root, "ckpt")
    tree = dict(stats_impl="tree", params_impl="tree")
    grid, line, accum = (dict(mesh_data=2, mesh_model=2), dict(mesh_data=2),
                         dict(step_impl="accum_norm"))
    plan = {4: [("fsdp-flat-2x2", grid),
                ("fsdp-tree-2x2", dict(checkpoint_dir=ck, checkpoint_every=2, **tree, **grid)),
                ("fsdp-tree-2x2-resume", dict(checkpoint_dir=ck + "-resume", resume=True,
                                              **tree, **grid))],
            2: [("fsdp-flat-2x1", line), ("fsdp-tree-2x1", dict(**tree, **line)),
                ("accum-flat-J2", dict(**accum, **line))],
            1: [("accum-flat-J1", dict(mesh_data=1, base_micro_batch=4,
                                       max_micro_batch=4, **accum))]}
    runs, seqpar = {}, {}
    try:
        for world, group in plan.items():
            jobs = [(name, dict(MESH_JOB, **kw)) for name, kw in group]
            if world > 1:
                out, sp = spawn_workers(mesh_group_rank, world, jobs, L, root,
                                        backend="gloo")
                seqpar[(1, 2) if world == 2 else (2, 2)] = sp
            else:
                out = mesh_rank(jobs, L, root)
            for name, job in jobs:
                r = runs[name] = out[name]
                steps = [b - a for a, b in zip([0.0] + r["time"][:-1], r["time"])]
                say("mesh", nvidia_smi=smi, run=name,
                    grid=f"{job.get('mesh_data', 1)}x{job.get('mesh_model', 1)}",
                    step_impl=job["step_impl"], residency=job["params_impl"],
                    seconds=round(r["seconds"], 3),
                    step_ms=[round(1e3 * x, 3) for x in steps],
                    loss=r["loss"], var_l1=r["var_l1"], grad_sqnorm=r["grad_sqnorm"],
                    peak_mem_bytes=[x["peak_mem_bytes"] for x in r["ranks"]],
                    tp_allreduce_s_per_step=[round(x["tp_allreduce_s"] / len(steps), 4)
                                             for x in r["ranks"] if x.get("tp_allreduce_s") is not None],
                    launches=r["ranks"][0]["launches"])
        ck_bytes = same_checkpoint(ck, ck + "-resume", MESH_JOB["steps"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    flat_pair = mesh_agree(runs, "fsdp-flat-2x2", "fsdp-flat-2x1", "flat 2x2 vs 2x1", dev)
    tree_pair = mesh_agree(runs, "fsdp-tree-2x2", "fsdp-tree-2x1", "tree 2x2 vs 2x1", dev)
    accum_pair = mesh_agree(runs, "accum-flat-J2", "accum-flat-J1",
                            "ACCUM-NORM J=2 vs J=1", dev, var_scale=2.0)
    res, full = runs["fsdp-tree-2x2-resume"], runs["fsdp-tree-2x2"]
    same_suffix(res, full, 2)
    if not all(torch.equal(x, y) for x, y in zip(res["final_params"], full["final_params"])):
        raise AssertionError("resumed params differ from the uninterrupted run's")
    for r in runs.values():
        del r["final_params"]

    main = runs["fsdp-flat-2x2"]
    groups = len({dt for _, dts in main["flat_calls"]["fused_adamw_stats"] for dt in dts})
    steps = MESH_JOB["steps"]
    evals = {"flash_attention": L, "rmsnorm": 2 * L + 1}
    zero = {k: 0 for k in KERNELS}
    want = {"fsdp-flat-2x2": zero | evals | {"fused_stats": steps,
                                             "fused_adamw_stats": steps * groups},
            "accum-flat-J2": zero | evals | {"fused_adamw_stats": steps * groups},
            "fsdp-tree-2x2": zero | evals | {"fused_adamw": steps, "sqdiff_norm": steps}}
    for name, w in want.items():
        for rank, r in enumerate(runs[name]["ranks"]):
            if r["launches"] != w:
                raise AssertionError(f"{name} rank {rank} launched {r['launches']}, "
                                     f"expected {w}")
    flash_heads = {c[0][2] for c in main["calls"]["flash_attention"]}
    if flash_heads != {16 // 2}:
        raise AssertionError(f"flash ran on {flash_heads} heads, not 8 of 16")
    flat = {k: main["flat_calls"][k] + runs["accum-flat-J2"]["flat_calls"][k]
            + runs["fsdp-tree-2x2"]["flat_calls"][k] for k in main["flat_calls"]}
    err = {**check_path_shapes(main["calls"], dev), **check_flat_shapes(flat, dev)}
    # the grid's launches: the 2 x 2 flat run's, and the tree routes' of the
    # 2 x 2 tree run (every rank)
    launches = {k: sum(r["launches"][k] for r in main["ranks"]) for k in KERNELS}
    for k in ("fused_adamw", "sqdiff_norm"):
        launches[k] = sum(r["launches"][k] for r in runs["fsdp-tree-2x2"]["ranks"])
    peaks = {n: max(x["peak_mem_bytes"] for x in r["ranks"]) for n, r in runs.items()}
    say("mesh", nvidia_smi=smi, layers=L, seconds=round(time.time() - t_phase, 3),
        flat_2x2_vs_2x1=flat_pair, tree_2x2_vs_2x1=tree_pair,
        accum_J2_vs_J1=accum_pair, resume="bit-identical", checkpoint_bytes=ck_bytes,
        peak_mem_bytes_max_rank=peaks,
        tree_peak_saving_bytes=peaks["fsdp-tree-2x1"] - peaks["fsdp-tree-2x2"],
        flash_calls=[list(c[0]) for c in main["calls"]["flash_attention"]],
        rmsnorm_calls=[list(c[0]) for c in main["calls"]["rmsnorm"]],
        flat_buckets={k: [len(c[0]) for c in v] for k, v in flat.items()},
        launches=launches, max_abs_err=err)
    return launches, err, seqpar


def kinds_block_rank(names):
    """One rank of phase mesh-kinds (a) on a (1, 2) mesh.  Per block the
    ranks first run it whole one after another (one whole block on the
    card at a time), each keeping on the host its slices of the leaves'
    gradients and of the output and dx: whole for the tensor-parallel run,
    its rows of the sequence for the sequence-parallel one.  Then the block
    runs tensor-parallel and under sequence parallelism.  Returns every
    rank's {block: {"tp" | "sp": largest relative error (a "partial"
    leaf's gradient summed over the model group first), roles, seconds of
    the forward and backward, TP counters, peak bytes}}."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.distributed import params as P
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, TP_STATS, reset_tp_stats, use_sharding_rules,
        with_sequence_parallel)
    from repro_torch.launch import mesh as M
    from repro_torch.models import blocks as blk
    from repro_torch.tree import (
        tree_flatten, tree_leaves, tree_map, tree_paths, tree_unflatten)

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = M.make_host_mesh(data=1, model=2)
    rank, size = dist.get_rank(), 2
    modes = {"tp": DEFAULT_RULES, "sp": with_sequence_parallel(DEFAULT_RULES)}
    out = {}
    for i, name in enumerate(names):
        arch, kind, moe_layer, (b, t) = KINDS_BLOCKS[name]
        cfg = get_config(arch)
        if moe_layer:   # a capacity where no pair drops
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        causal = cfg.encoder is None            # whisper: an encoder layer
        make = lambda: {"layers": [blk.init_block(
            torch.Generator(device=dev).manual_seed(i), cfg, kind, moe_layer, dev)]}
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        x0 = torch.randn((b, t, cfg.d_model), device=dev, generator=gen)
        up0 = torch.randn((b, t, cfg.d_model), device=dev, generator=gen)
        pos = torch.arange(t, device=dev).expand(b, t)
        c = -(-t // size)
        n = min(c, t - rank * c)                 # real rows of this rank's slice

        def mine(x):                             # this rank's slice, zero-padded
            return F.pad(x, (0, 0, 0, size * c - t))[:, rank * c:(rank + 1) * c]

        def run(tree, mode):
            leaves, treedef = tree_flatten(tree)
            ps = [p.detach().requires_grad_(True) for p in leaves]
            sp = mode == "sp"
            x = (mine(x0) if sp else x0).clone().requires_grad_(True)
            with use_sharding_rules(modes.get(mode), mesh):
                y, aux, _ = blk.block_full(tree_unflatten(treedef, ps)["layers"][0], x,
                                           pos, cfg, kind, moe_layer, causal=causal)
                up = mine(up0) if sp else up0
                grads = torch.autograd.grad((y * up).sum() + 100 * aux, ps + [x])
            return y.detach(), grads[-1], grads[:-1]

        for r in range(size):
            if r == rank:
                tree = make()
                specs = P.param_pspecs(tree, mesh)
                y, dx, g = run(tree, "whole")
                g = [x.cpu() for x in tree_leaves(P.shard_tree(
                    tree_unflatten(tree_flatten(tree)[1], list(g)), specs, mesh))]
                want = {"tp": [y.cpu(), dx.cpu()] + g,
                        "sp": [mine(y)[:, :n].cpu(), mine(dx)[:, :n].cpu()] + g}
                del tree, y, dx, g
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        tree = make()
        local = tree_map(lambda x: x.contiguous(), P.shard_tree(tree, specs, mesh))
        del tree
        keys = ["out", "dx"] + [k for k, _ in tree_paths(local)]
        out[name] = {}
        for mode in modes:
            roles = tree_flatten(P.model_roles(local, specs,
                                               sequence_parallel=mode == "sp"))[0]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_tp_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            y, dx, g = run(local, mode)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            got = [y[:, :n], dx[:, :n]] if mode == "sp" else [y, dx]
            got += [M.psum(x.clone(), mesh.model_group) if role == "partial" else x
                    for x, role in zip(g, roles)]
            errs = {k: float((a - w.to(dev)).abs().max() / w.abs().max().to(dev))
                    for k, a, w in zip(keys, got, want[mode])}
            worst = max(errs, key=errs.get)
            out[name][mode] = {
                "max_rel_err": errs[worst], "worst": worst, "tokens": [b, t],
                "sharded": roles.count("sharded"), "partial": roles.count("partial"),
                "replicated": roles.count("replicated"), "fwd_bwd_s": round(seconds, 3),
                "tp": dict(TP_STATS), "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
            del y, dx, g, got
        del local, want
        gc.collect()
        torch.cuda.empty_cache()
    every = [None] * size
    dist.all_gather_object(every, out)
    return every


def mesh_kinds_phase(smi, ops, dev) -> tuple:
    """Phase mesh-kinds: the MoE, MLA, SSD and RG-LRU layers on the model
    axis, on gloo ranks that share the card.

    (a) One block of each kind at full width (KINDS_BLOCKS), tokens from a
    seed, on 2 ranks against the same block whole, tensor-parallel and
    under sequence parallelism: output, dx and every leaf's gradient within
    KINDS_RTOL.
    (b) `run_training` at full width, depth cut (KINDS_LAYERS): mamba2-370m
    FSDP-Norm flat/flat and the mixed residency (stats flat, params tree)
    on 2 x 2 against 2 x 1; recurrentgemma-9b FSDP-Norm tree/tree (the tree
    routes) on 1 x 2 against 1 x 1, its eval's flash on 8 local q heads of
    16 at head dim 256 beside its one kv head, replicated.  The metrics
    within MESH_RTOL, the final params by the per-entry share, each rank's
    launches, every kernel against its plain version at the phase's
    shapes.  Memory rules out the rest: recurrentgemma-9b's 2.17 B f32
    parameters need p, m, v and two whole gradient buffers on each rank of
    a flat ACCUM-NORM 1 x 2 (~44 GB a rank, two on one card), and ~38 GB a
    rank as a tree (its vocab table whole under ZeRO-3's specs), while
    FSDP-Norm's tree slices hold ~26 GB a rank; dbrx's and deepseek-v2's
    expert layers alone are 12.7 and 15.1 GB of f32 parameters, so p, m, v,
    g and g_j of one layer pass 80 GB even over 2 ranks, and they train on
    the grid at smoke width only (tests/test_torch_tp_kinds.py).
    Returns (each kernel's launches on the phase's main runs, summed over
    their ranks; each kernel's max abs error at the phase's shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_workers

    # repro: allow(unfenced-timing) — phase wall clock; the phase ends in host reads of its results and joined child ranks, so no device work is left in flight
    t_phase = time.time()
    # the card as empty as this process can leave it: recurrentgemma's 1 x 1
    # run here peaks near 70 GB
    gc.collect()
    torch.cuda.empty_cache()
    blocks = spawn_workers(kinds_block_rank, 2, list(KINDS_BLOCKS), backend="gloo")
    for name in KINDS_BLOCKS:
        for mode, what in (("tp", "tensor"), ("sp", "sequence")):
            worst = max(r[name][mode]["max_rel_err"] for r in blocks)
            say("mesh-kinds", nvidia_smi=smi, block=name, parallelism=what,
                max_rel_err=worst, limit=KINDS_RTOL, ranks=[r[name][mode] for r in blocks])
            if not worst <= KINDS_RTOL:
                raise AssertionError(f"{name}: {what}-parallel vs whole {worst} > "
                                     f"{KINDS_RTOL}")
        if not all(r[name]["sp"]["tp"]["seq_all_gather"] > 0 for r in blocks):
            raise AssertionError(f"{name}: the sequence-parallel stream was never gathered")

    grid, line = dict(mesh_data=2, mesh_model=2), dict(mesh_data=2)
    mixed = dict(stats_impl="flat", params_impl="tree")
    tree = dict(arch="recurrentgemma-9b", stats_impl="tree", params_impl="tree")
    plan = [("mamba2-370m", 4, [("ssd-flat-2x2", grid), ("ssd-mixed-2x2", dict(**mixed, **grid))]),
            ("mamba2-370m", 2, [("ssd-flat-2x1", line), ("ssd-mixed-2x1", dict(**mixed, **line))]),
            ("recurrentgemma-9b", 2, [("rglru-tree-1x2", dict(mesh_data=1, mesh_model=2, **tree))]),
            ("recurrentgemma-9b", 1, [("rglru-tree-1x1", dict(mesh_data=1, **tree))])]
    runs = {}
    for arch, world, group in plan:
        jobs = [(name, dict(KINDS_JOB, **kw)) for name, kw in group]
        out = (spawn_workers(mesh_rank, world, jobs, KINDS_LAYERS[arch], "", backend="gloo")
               if world > 1 else mesh_rank(jobs, KINDS_LAYERS[arch], ""))
        for name, job in jobs:
            r = runs[name] = out[name]
            steps = [b - a for a, b in zip([0.0] + r["time"][:-1], r["time"])]
            say("mesh-kinds", nvidia_smi=smi, run=name, arch=arch,
                layers=KINDS_LAYERS[arch], grid=f"{job['mesh_data']}x{job.get('mesh_model', 1)}",
                stats=job["stats_impl"], params=job["params_impl"],
                seconds=round(r["seconds"], 3), step_ms=[round(1e3 * x, 3) for x in steps],
                loss=r["loss"], var_l1=r["var_l1"], grad_sqnorm=r["grad_sqnorm"],
                peak_mem_bytes=[x["peak_mem_bytes"] for x in r["ranks"]],
                tp_allreduce_s_per_step=[round(x["tp_allreduce_s"] / len(steps), 4)
                                         for x in r["ranks"] if x.get("tp_allreduce_s") is not None],
                launches=r["ranks"][0]["launches"])
        del out
        gc.collect()
        torch.cuda.empty_cache()

    pairs = {what: mesh_agree(runs, a, b, what, dev) for what, a, b in (
        ("ssd flat 2x2 vs 2x1", "ssd-flat-2x2", "ssd-flat-2x1"),
        ("ssd mixed 2x2 vs 2x1", "ssd-mixed-2x2", "ssd-mixed-2x1"),
        ("rglru tree 1x2 vs 1x1", "rglru-tree-1x2", "rglru-tree-1x1"))}
    for r in runs.values():
        del r["final_params"]
    steps = KINDS_JOB["steps"]
    zero = {k: 0 for k in KERNELS}
    ssd_cfg, rg_cfg = (get_config(a).replace(num_layers=n) for a, n in KINDS_LAYERS.items())
    flat = runs["ssd-flat-2x2"]
    groups = len({dt for _, dts in flat["flat_calls"]["fused_adamw_stats"] for dt in dts})
    tail = {"fused_stats": steps, "fused_adamw_stats": steps * groups}
    want = {"ssd-flat-2x2": zero | forward_kernel_launches(ssd_cfg) | tail,
            "ssd-mixed-2x2": zero | forward_kernel_launches(ssd_cfg) | tail,
            "rglru-tree-1x2": zero | forward_kernel_launches(rg_cfg)
            | {"fused_adamw": steps, "sqdiff_norm": steps}}
    for name, w in want.items():
        for rank, r in enumerate(runs[name]["ranks"]):
            if r["launches"] != w:
                raise AssertionError(f"{name} rank {rank} launched {r['launches']}, "
                                     f"expected {w}")
    rg = runs["rglru-tree-1x2"]
    flash = {(c[0][2], c[0][3], c[1][2]) for c in rg["calls"]["flash_attention"]}
    if flash != {(rg_cfg.num_heads // 2, rg_cfg.head_dim, rg_cfg.num_heads // 2)}:
        raise AssertionError(f"recurrentgemma's flash ran as (q heads, d, kv heads) "
                             f"{flash}, not 8 local q heads of 16 at d 256")
    calls = {k: flat["calls"][k] + rg["calls"][k] for k in flat["calls"]}
    flat_calls = {k: flat["flat_calls"][k] + runs["ssd-mixed-2x2"]["flat_calls"][k]
                  + rg["flat_calls"][k] for k in flat["flat_calls"]}
    err = {**check_path_shapes(calls, dev), **check_flat_shapes(flat_calls, dev)}
    launches = {k: sum(sum(r["launches"][k] for r in runs[n]["ranks"]) for n in want)
                for k in KERNELS}
    say("mesh-kinds", nvidia_smi=smi, seconds=round(time.time() - t_phase, 3),
        layers=KINDS_LAYERS, **{k.replace(" ", "_"): v for k, v in pairs.items()},
        peak_mem_bytes_max_rank={n: max(x["peak_mem_bytes"] for x in r["ranks"])
                                 for n, r in runs.items()},
        flash_calls=[list(c[0]) + list(c[1]) for c in rg["calls"]["flash_attention"]],
        rmsnorm_calls=[list(c[0]) for c in calls["rmsnorm"]],
        launches=launches, max_abs_err=err)
    return launches, err


def seqpar_train_rank(grid, layers):
    """This rank of phase seqpar (a): FSDP-Norm flat/flat of full-width
    microllama-300m cut to `layers` layers on the `grid` (data, model),
    sequence parallelism off and then on, each from the seed-0 parameters
    over the same batches.  Returns, per setting, every rank's metrics,
    step seconds, peak bytes, TP counters and launches, rank 0's whole
    final parameters on the host, and the tail's call shapes."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import MarkovTokens, make_batch
    from repro_torch.distributed.sharding import (
        TP_STATS, gather_flat_buffers, reset_tp_stats, shard_flat_buffers)
    from repro_torch.distributed.train_step import batch_to_device, make_fsdp_norm_step
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = grid
    mesh = M.make_host_mesh(data=d, model=m)
    model = build_model(get_config(MESH_JOB["arch"]).replace(num_layers=layers))
    plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=4 // d, workers=d)
    src = MarkovTokens(vocab_size=model.cfg.vocab_size, seed=0)
    batches = [make_batch(src, t, plan, SEQPAR_SEQ) for t in range(SEQPAR_STEPS)]
    out = {}
    for sp in (False, True):
        params = model.init(0, device=dev)
        wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl="flat",
                                   params_impl="flat", sequence_parallel=sp,
                                   params_like=params, mesh=mesh)
        layout = wrap.flat_layout
        opt = init_adamw_flat(params, shard_divisor=d, layout=layout)
        pb = tuple(shard_flat_buffers(layout.flatten(params), mesh))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_tp_stats()
        ops.reset_launch_counts()
        mine = {"loss": [], "var_l1": [], "grad_sqnorm": [], "step_s": []}
        with recorded_flat_calls(ops) as flat:
            for b in batches:
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pb, opt, mt = wrap(b)(pb, opt, batch_to_device(b, dev), 3e-4)
                for k in ("loss", "var_l1", "grad_sqnorm"):
                    mine[k].append(float(mt[k]))
                mine["step_s"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        mine.update(peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                    launches=ops.launch_counts(), tp=dict(TP_STATS))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        whole = layout.unflatten(gather_flat_buffers(pb, mesh=mesh))
        out[sp] = {"ranks": every, "flat_calls": flat,
                   "final_params": [x.detach().cpu() for x in tree_leaves(whole)]}
        del pb, opt, whole
        gc.collect()
        torch.cuda.empty_cache()
    return out


def seqpar_phase(smi, ops, dev, trained=None) -> tuple:
    """Phase seqpar (module docstring) from `trained`, {grid:
    `seqpar_train_rank`'s result} that phase mesh's rank groups ran, or, as
    the phase run alone, from groups of 2 and 4 ranks of its own.  Returns
    (each kernel's launches on the phase's sequence-parallel runs, summed
    over their ranks; each kernel's max abs error at the phase's
    shapes)."""
    from repro_torch.launch.mesh import spawn_workers

    # repro: allow(unfenced-timing) — phase wall clock; the phase ends in host reads of its results and joined child ranks, so no device work is left in flight
    t_phase = time.time()
    if trained is None:
        trained = {grid: spawn_workers(seqpar_train_rank, grid[0] * grid[1], grid,
                                       SEQPAR_LAYERS, backend="gloo")
                   for grid in SEQPAR_GRIDS}
    zero = {k: 0 for k in KERNELS}
    launches, flat_calls, err = dict(zero), None, {}
    for grid in SEQPAR_GRIDS:
        out = trained[grid]
        runs = {("sp" if sp else "whole"): {
            "loss": r["ranks"][0]["loss"], "var_l1": r["ranks"][0]["var_l1"],
            "grad_sqnorm": r["ranks"][0]["grad_sqnorm"],
            "final_params": r["final_params"]} for sp, r in out.items()}
        what = f"seqpar {grid[0]}x{grid[1]} on vs off"
        pair = mesh_agree(runs, "sp", "whole", what, dev)
        groups = len({dt for _, dts in out[True]["flat_calls"]["fused_adamw_stats"]
                      for dt in dts})
        want = zero | {"fused_stats": SEQPAR_STEPS,
                       "fused_adamw_stats": SEQPAR_STEPS * groups}
        for sp, r in out.items():
            for rank, x in enumerate(r["ranks"]):
                if x["launches"] != want:
                    raise AssertionError(f"{what}: sp={sp} rank {rank} launched "
                                         f"{x['launches']}, expected {want}")
            say("seqpar", nvidia_smi=smi, grid=f"{grid[0]}x{grid[1]}", layers=SEQPAR_LAYERS,
                sequence_parallel=sp, loss=r["ranks"][0]["loss"],
                var_l1=r["ranks"][0]["var_l1"], grad_sqnorm=r["ranks"][0]["grad_sqnorm"],
                step_ms=[[round(1e3 * s, 3) for s in x["step_s"]] for x in r["ranks"]],
                peak_mem_bytes=[x["peak_mem_bytes"] for x in r["ranks"]],
                tp_calls=[x["tp"]["calls"] for x in r["ranks"]],
                tp_seconds=[round(x["tp"]["seconds"], 4) for x in r["ranks"]],
                seq_reduce_scatters=[x["tp"]["seq_reduce_scatter"] for x in r["ranks"]],
                seq_all_gathers=[x["tp"]["seq_all_gather"] for x in r["ranks"]],
                gloo_reduce_scatter="dist.reduce_scatter_tensor on CUDA tensors"
                if sp else None)
            if sp and not all(x["tp"]["seq_reduce_scatter"] > 0 for x in r["ranks"]):
                raise AssertionError(f"{what}: a rank ran no sequence reduce-scatter")
        say("seqpar", nvidia_smi=smi, grid=f"{grid[0]}x{grid[1]}", on_vs_off=pair,
            limit_rtol=MESH_RTOL, share_limit=MESH_SHARE)
        for k in KERNELS:
            launches[k] += sum(x["launches"][k] for x in out[True]["ranks"])
        flat_calls = out[True]["flat_calls"] if flat_calls is None else {
            k: flat_calls[k] + out[True]["flat_calls"][k] for k in flat_calls}
        del out, runs
    trained.clear()
    err.update(check_flat_shapes(flat_calls, dev))

    say("seqpar", nvidia_smi=smi, seconds=round(time.time() - t_phase, 3),
        launches=launches, max_abs_err=err)
    return launches, err


def sm_counted(ops, fn):
    """(fn(), this rank's launches, its kernel calls' shapes): the counts
    set to 0 just before and read just after."""
    ops.reset_launch_counts()
    with recorded_kernel_calls(ops) as calls:
        out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts(), calls


def sm_prefill(ops, model, whole, mesh, dev) -> dict:
    """A 4 x 2048 prefill on this rank's slices of the 1 x 2 grid: its
    launches (flash on 16 of the 32 heads a rank) and ms; rank 0 holds the
    logits and the gathered caches against the one-process prefill."""
    import torch.distributed as dist
    from repro_torch.distributed.params import cache_pspecs, gather_tree
    from repro_torch.distributed.serve_step import make_prefill, param_slices

    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           device=dev, generator=gen)
    wrap, p_specs = make_prefill(model, mesh, batch=PREFILL_BATCH)
    run, local = wrap(), param_slices(whole, p_specs, mesh)
    run(local, {"tokens": tokens[:, :64]})                # cuBLAS warm-up
    dist.barrier()
    t0 = time.perf_counter()
    (logits, caches), launches, calls = sm_counted(ops, lambda: run(local, {"tokens": tokens}))
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    like = model.init_cache(PREFILL_BATCH, PREFILL_LEN, device="meta")
    caches = gather_tree(caches, cache_pspecs(like, mesh, batch_divisible=True), mesh)
    del local
    out = {"ms": ms, "launches": launches, "calls": calls}
    if dist.get_rank() == 0:
        with torch.inference_mode():
            want_logits, want = model.prefill(whole, {"tokens": tokens})
        out["rel_errs"] = {"logits": rel_err(logits, want_logits),
                           "caches": caches_rel_err(caches, want)}
    del caches
    return out


def sm_serving(ops, model, whole, mesh, dev) -> dict:
    """`run_serving` on this grid (graphs on a model axis of 1, eager
    above), each step's logits held against the one-process step on the
    same tokens (on the model index 0 ranks, each its data rows): the
    eager run's own (`on_logits`), a graph run's through the grid's eager
    decode step teacher-forced on its tokens; and the greedy tokens
    wherever the one-process top-2 margin exceeds twice the tolerance."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.params import cache_pspecs
    from repro_torch.distributed.serve_step import (
        data_rows, local_cache, make_decode_step, param_slices)
    from repro_torch.distributed.sharding import TP_STATS
    from repro_torch.launch.serve import run_serving

    d, m = mesh.shape["data"], mesh.shape["model"]
    graphs, stash = m == 1, []
    keep = None if graphs else (lambda i, logits: stash.append(logits.clone()))
    dist.barrier()
    TP_STATS.update(calls=0, seconds=0.0)
    res, launches, calls = sm_counted(ops, lambda: run_serving(
        SERVE_ARCH, smoke=False, params=whole, mesh_data=d, mesh_model=m,
        on_logits=keep, **SERVE_JOB))
    b, plen, glen = SERVE_JOB["batch"], SERVE_JOB["prompt_len"], SERVE_JOB["gen_len"]
    tp = dict(TP_STATS, steps=plen + glen - 1)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab_size, (b, plen)).astype(np.int32)
    rows = data_rows(b, mesh)
    feed = torch.from_numpy(np.concatenate([prompts, res["tokens"]], 1)[rows]).to(dev)
    gen_tok = torch.from_numpy(res["tokens"][rows]).to(dev)
    if graphs:         # the grid's eager step, teacher-forced on the run's tokens
        like = model.init_cache(b, plen + glen, device="meta")
        wrap, p_specs = make_decode_step(model, mesh, batch=b)
        step, local = wrap(like), param_slices(whole, p_specs, mesh)
        cache = local_cache(like, cache_pspecs(like, mesh, batch_divisible=True), mesh, dev)

        def grid_logits(i):
            return step(local, cache, feed[:, i], i)[0]
    else:
        grid_logits = stash.__getitem__
    ref = mesh.model_index == 0
    if ref:
        solo = make_decode_step(model)
        ref_cache = model.init_cache(feed.shape[0], plen + glen, device=dev)
    err, checked, mismatched = 0.0, 0, 0
    for i in range(plen + glen - 1):
        logits = grid_logits(i)
        if not ref:
            continue
        want, ref_cache = solo(whole, ref_cache, feed[:, i], i)
        err = max(err, rel_err(logits, want))
        if i >= plen - 1:
            top = torch.topk(want, 2, dim=-1).values
            decided = (top[:, 0] - top[:, 1]) > 2 * SERVE_REL * want.abs().max()
            same = gen_tok[:, i - plen + 1] == want.argmax(-1)
            checked += int(decided.sum())
            mismatched += int((decided & ~same).sum())
    del stash
    return {"tokens": res["tokens"], "decode_ms_per_step": 1e3 * res["decode_s"] / (glen - 1),
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "launches": launches, "calls": calls, "max_rel_err": err,
            "tp_collectives_per_step": tp["calls"] / tp["steps"],
            "tp_collective_ms_per_step": 1e3 * tp["seconds"] / tp["steps"],
            "greedy_checked": checked, "greedy_mismatched": mismatched}


def sm_continuous(ops, whole, mesh) -> dict:
    from repro_torch.launch.serve import run_continuous_serving

    res, launches, calls = sm_counted(ops, lambda: run_continuous_serving(
        SERVE_ARCH, smoke=False, params=whole, mesh_data=mesh.shape["data"],
        mesh_model=mesh.shape["model"], **CONT_JOB))
    return {"res": res, "launches": launches, "calls": calls}


def sm_piece(ops, name, mesh, dev) -> dict:
    """One full-width block of a layer kind on this rank's slices of the
    1 x 2 grid: a prefill of SM_PIECE_TOKENS, its cache placed in a decode
    cache of SM_PIECE_CACHE positions, then SM_PIECE_STEPS decode steps at
    per-row positions (row 1 crossing the middle of the cache: MLA's 8192
    latents change rank there).  Rank 0 first runs the block whole (the
    other waits); then both run it tensor-parallel, and rank 0 holds the
    outputs and the gathered caches against the whole run's."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.params import (
        cache_pspecs, gather_tree, param_pspecs, shard_tree)
    from repro_torch.distributed.serve_step import _serve_rules, layer_seq_shards
    from repro_torch.distributed.sharding import use_sharding_rules
    from repro_torch.models import blocks as B
    from repro_torch.tree import tree_map

    arch, kind, moe = SM_PIECES[name]
    cfg = get_config(arch)
    b, t = SM_PIECE_TOKENS
    length = SM_PIECE_CACHE.get(name, SM_PIECE_CACHE_DEFAULT)
    seed = list(SM_PIECES).index(name)
    make = lambda: {"layers": [B.init_block(torch.Generator(device=dev).manual_seed(seed),
                                            cfg, kind, moe, dev)]}
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    x = torch.randn((b, t, cfg.d_model), device=dev, generator=gen)
    xs = [torch.randn((b, 1, cfg.d_model), device=dev, generator=gen)
          for _ in range(SM_PIECE_STEPS)]
    positions = torch.arange(t, device=dev).expand(b, t)
    pos = [torch.tensor([t + i, length // 2 - SM_PIECE_STEPS // 2 + i], device=dev)
           for i in range(SM_PIECE_STEPS)]
    cache_of = lambda n, d: [B.init_block_cache(cfg, kind, b, n, cfg.act_dtype, d)]
    specs = cache_pspecs(cache_of(length, "meta"), mesh, batch_divisible=True)
    pre_specs = cache_pspecs(cache_of(t, "meta"), mesh, batch_divisible=True)
    seq = layer_seq_shards(specs)[0]

    def run(p, cache, start, seq_sharded):
        """The prefill's output and cache, the cache placed in `cache`
        (which holds positions [start, start + its length)), then the
        decode steps' outputs; `cache` is written in place."""
        with torch.inference_mode():
            y, _, pre = B.block_full(p, x, positions, cfg, kind, moe, collect_cache=True)
            for k, c in (pre or {}).items():
                lo, hi = start, min(start + cache[k].shape[1], t)
                if lo < hi:
                    cache[k][:, :hi - lo].copy_(c[:, lo:hi])
            outs = [B.block_decode(p, xi, cache, pi, cfg, kind, moe, seq_sharded=seq_sharded)[0]
                    for xi, pi in zip(xs, pos)]
        return y, pre, outs, cache

    want = None
    if dist.get_rank() == 0:
        tree = make()
        want = tree_map(lambda v: v.cpu(), run(tree["layers"][0],
                                                cache_of(length, dev)[0], 0, False))
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    tree = make()
    local = tree_map(lambda v: v.contiguous(),
                     shard_tree(tree, param_pspecs(tree, mesh), mesh))["layers"][0]
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    cache = tree_map(lambda v: v.contiguous(), shard_tree(cache_of(length, dev), specs, mesh))[0]
    first = next(iter(cache.values()))
    start = mesh.model_index * first.shape[1] if seq else 0
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t0 = time.perf_counter()
    with use_sharding_rules(_serve_rules(mesh, b), mesh):
        (y, pre, outs, cache), launches, calls = sm_counted(
            ops, lambda: run(local, cache, start, seq))
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    cache = gather_tree([cache], specs, mesh)[0]
    if pre is not None:
        pre = gather_tree([{k: c.contiguous() for k, c in pre.items()}], pre_specs, mesh)[0]
    out = {"seconds": secs, "launches": launches, "calls": calls, "peak_mem_bytes": peak,
           "cache_seq_sharded": seq}
    if want is not None:
        wy, wpre, wouts, wcache = want
        errs = {"prefill_out": rel_err(y, wy),
                "decode_out": max(rel_err(a, w) for a, w in zip(outs, wouts)),
                "decode_cache": max(rel_err(cache[k], wcache[k]) for k in wcache)}
        if wpre is not None:
            errs["prefill_cache"] = max(rel_err(pre[k], wpre[k]) for k in wpre)
        out["rel_errs"] = errs
    del local, cache, y, pre, outs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def piece_launches(arch: str, kind: str) -> dict:
    """A piece's kernel launches a rank: flash once in an attention
    block's prefill; rmsnorm at each of the block's norms where they are
    RMSNorm (LayerNorm has none), and MLA's `q_norm` and `kv_norm`, in the
    prefill and every decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import has_mlp

    cfg = get_config(arch)
    norms = (1 + has_mlp(cfg, kind)) * (1 + cfg.post_attn_norm) * (cfg.norm_kind == "rmsnorm")
    if kind == "mla":
        norms += 1 + bool(cfg.mla.q_lora_rank)
    return {"flash_attention": int(kind in ("attn", "local")),
            "rmsnorm": norms * (1 + SM_PIECE_STEPS)}


def serve_mesh_rank(world: int):
    """One rank of phase serve-mesh.  On 2 ranks: the 1 x 2 prefill,
    `run_serving` on 2 x 1 and 1 x 2, `run_continuous_serving` on 2 x 1,
    then the layer-kind pieces on 1 x 2; on 4: `run_serving` and
    `run_continuous_serving` on 2 x 2.  Returns every rank's results."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model

    import faulthandler

    # a rank still here near the group's time limit prints where it waits
    faulthandler.dump_traceback_later(SM_TIMEOUT_S - 30)
    rank, t0 = dist.get_rank(), time.time()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_model(get_config(SERVE_ARCH).replace(num_layers=SM_LAYERS))
    whole = model.init(0, dev)
    out = {}

    def part(name, fn):
        out[name] = fn()
        say("serve-mesh", rank=rank, world=world, done=name,
            seconds=round(time.time() - t0, 1))

    if world == 2:
        grid, line = make_host_mesh(data=1, model=2), make_host_mesh(data=2, model=1)
        part("prefill-1x2", lambda: sm_prefill(ops, model, whole, grid, dev))
        part("serving-2x1", lambda: sm_serving(ops, model, whole, line, dev))
        part("serving-1x2", lambda: sm_serving(ops, model, whole, grid, dev))
        part("continuous-2x1", lambda: sm_continuous(ops, whole, line))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        for name in SM_PIECES:
            part(f"piece-{name}", lambda: sm_piece(ops, name, grid, dev))
    else:
        grid = make_host_mesh(data=2, model=2)
        part("serving-2x2", lambda: sm_serving(ops, model, whole, grid, dev))
        part("continuous-2x2", lambda: sm_continuous(ops, whole, grid))
    faulthandler.cancel_dump_traceback_later()
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def serve_mesh_phase(smi, ops, dev) -> tuple:
    """Phase serve-mesh: serving on a data x model grid of gloo ranks that
    share the card (module docstring).  Returns (each kernel's launches on
    the phase's grid runs, summed over their ranks; each kernel's max abs
    error at the shapes the phase gave it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_workers
    from repro_torch.launch.serve import run_continuous_serving, run_serving
    from repro_torch.models.model import build_model

    # repro: allow(unfenced-timing) — phase wall clock; the phase ends in host reads of its results and joined child ranks, so no device work is left in flight
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH).replace(num_layers=SM_LAYERS)
    params = build_model(cfg).init(0, dev)
    solo = {"serving": run_serving(SERVE_ARCH, smoke=False, params=params, **SERVE_JOB),
            "continuous": run_continuous_serving(SERVE_ARCH, smoke=False, params=params,
                                                 **CONT_JOB)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say("serve-mesh", done="one process", seconds=round(time.time() - t_phase, 1))
    ranks = {}
    for world in (2, 4):
        every = spawn_workers(serve_mesh_rank, world, world, backend="gloo",
                              timeout_s=SM_TIMEOUT_S)
        ranks.update({k: [r[k] for r in every] for k in every[0]})
        del every
    launches, err = serve_mesh_checks(smi, ranks, solo, cfg, dev)
    say("serve-mesh", nvidia_smi=smi, seconds=round(time.time() - t_phase, 3),
        launches=launches, max_abs_err=err)
    return launches, err


def serve_mesh_checks(smi, ranks, solo, cfg, dev) -> tuple:
    """Phase serve-mesh's assertions and lines, from every rank's results
    (`ranks`: part -> one result a rank) and the one-process runs
    (`solo`).  Returns (launches summed over the ranks, each kernel's max
    abs error at the shapes the grid runs gave it)."""
    layers, zero = cfg.num_layers, {k: 0 for k in KERNELS}
    per_step = 2 * layers + 1

    pre = ranks["prefill-1x2"]
    want = zero | {"flash_attention": layers, "rmsnorm": per_step}
    heads = {(c[0][2], c[1][2]) for r in pre for c in r["calls"]["flash_attention"]}
    if any(r["launches"] != want for r in pre) or heads != {(cfg.num_heads // 2,
                                                            cfg.num_kv_heads // 2)}:
        raise AssertionError(f"prefill 1x2 launched {[r['launches'] for r in pre]} "
                             f"on (q, kv) heads {heads}, expected {want} on 16 and 4")
    if not max(pre[0]["rel_errs"].values()) <= SERVE_REL:
        raise AssertionError(f"prefill 1x2 vs one process: {pre[0]['rel_errs']} "
                             f"> {SERVE_REL}")
    say("serve-mesh", part="prefill", nvidia_smi=smi, grid="1x2", batch=PREFILL_BATCH,
        tokens=PREFILL_LEN, ms=[r["ms"] for r in pre], rel_errs=pre[0]["rel_errs"],
        limit=SERVE_REL, flash_heads_q_kv=sorted(heads), launches=pre[0]["launches"])

    steps = SERVE_JOB["prompt_len"] + SERVE_JOB["gen_len"] - 1
    for grid in ("2x1", "1x2", "2x2"):
        rs = ranks[f"serving-{grid}"]
        graphs = grid.endswith("x1")
        want = zero | {"rmsnorm": per_step * (steps + graphs)}
        errs = [r["max_rel_err"] for r in rs]
        bad = [r["launches"] for r in rs if r["launches"] != want]
        if bad or not max(errs) <= SERVE_REL or any(r["greedy_mismatched"] for r in rs):
            raise AssertionError(f"run_serving {grid}: launches {bad} (expected {want}), "
                                 f"teacher-forced logits {errs}, greedy mismatches "
                                 f"{[r['greedy_mismatched'] for r in rs]}")
        say("serve-mesh", part="run_serving", nvidia_smi=smi, grid=grid, **SERVE_JOB,
            cuda_graphs=graphs, decode_ms_per_step=[r["decode_ms_per_step"] for r in rs][:1],
            solo_decode_ms_per_step=1e3 * solo["serving"]["decode_s"] / (SERVE_JOB["gen_len"] - 1),
            prefill_s=rs[0]["prefill_s"], decode_s=rs[0]["decode_s"],
            teacher_forced_max_rel_err=max(errs), limit=SERVE_REL,
            tp_collectives_per_step=rs[0]["tp_collectives_per_step"],
            tp_collective_ms_per_step=[round(r["tp_collective_ms_per_step"], 3) for r in rs],
            greedy_checked=sum(r["greedy_checked"] for r in rs),
            tokens_equal_solo=bool((rs[0]["tokens"] == solo["serving"]["tokens"]).all()),
            launches=rs[0]["launches"])

    book = ("steps", "requests_completed", "tokens_generated", "prompt_tokens",
            "slot_resets", "slot_moves", "rung_transitions", "buckets_used", "compiles")
    one = solo["continuous"]
    for grid in ("2x1", "2x2"):
        rs = ranks[f"continuous-{grid}"]
        res = rs[0]["res"]
        same = (res["rung_trace"] == one["rung_trace"]
                and res["requests_completed"] == one["requests_completed"]
                and all(res["engine"][k] == one["engine"][k] for k in book))
        if (not same or not res["probe"]["steady_state_transition_hit"]
                or any(r["launches"]["flash_attention"] for r in rs)
                or not all(r["launches"]["rmsnorm"] for r in rs)):
            raise AssertionError(f"continuous {grid}: {res['rung_trace']} vs "
                                 f"{one['rung_trace']}, {res['engine']} vs {one['engine']}, "
                                 f"probe {res['probe']}, launches "
                                 f"{[r['launches'] for r in rs]}")
        say("serve-mesh", part="continuous", nvidia_smi=smi, grid=grid, **CONT_JOB,
            cuda_graphs=grid.endswith("x1"), load=res["load"],
            solo_load=one["load"], wall_s=res["wall_s"], probe=res["probe"],
            rung_trace_equal_solo=True, requests=res["requests_completed"],
            launches=[r["launches"] for r in rs])

    for name in SM_PIECES:
        rs = ranks[f"piece-{name}"]
        errs = rs[0]["rel_errs"]
        want = zero | piece_launches(*SM_PIECES[name][:2])
        if not max(errs.values()) <= SERVE_MESH_REL or any(r["launches"] != want for r in rs):
            raise AssertionError(f"{name} on 1x2 vs whole: {errs}, launches "
                                 f"{[r['launches'] for r in rs]}")
        say("serve-mesh", part="piece", nvidia_smi=smi, piece=name,
            tokens=list(SM_PIECE_TOKENS), decode_steps=SM_PIECE_STEPS,
            cache=SM_PIECE_CACHE.get(name, SM_PIECE_CACHE_DEFAULT),
            cache_seq_sharded=rs[0]["cache_seq_sharded"], rel_errs=errs,
            limit=SERVE_MESH_REL, seconds=[round(r["seconds"], 3) for r in rs],
            peak_mem_bytes=[r["peak_mem_bytes"] for r in rs],
            flash_calls=[list(c[0]) + list(c[1]) for c in rs[0]["calls"]["flash_attention"]],
            launches=rs[0]["launches"])

    calls = {"flash_attention": [], "rmsnorm": []}
    for rs in ranks.values():
        for r in rs:
            for k, cs in r["calls"].items():
                calls[k] += [c for c in cs if c not in calls[k]]
    err = check_path_shapes(calls, dev)
    launches = {k: sum(r["launches"][k] for rs in ranks.values() for r in rs) for k in KERNELS}
    return launches, err


def check_archs(smi, ops, dev):
    """Phase archs: every registered config at full width, depth cut to
    ARCH_LAYERS (1 layer for the dense Llama family).  Per config: the
    forward with grad mode off (the kernels; launches as
    `forward_kernel_launches` computes them from the config) against the
    plain forward under grad mode; prefill against the same tokens
    streamed through decode (`prefill_vs_decode`; an MoE config at a
    capacity where no pair drops); then a long prefill at the published
    capacity (ARCH_PREFILL: 2 x 2048; gemma2 and recurrentgemma one prompt
    of 8192 so their local layers mask beyond their windows; whisper 448
    decoder tokens over 1500 frames; internvl2 256 prefix and 1792 text
    tokens), three runs timed, with its launches.  Audio frames and patch
    embeddings are drawn from the seeded generator.  Each model is freed
    before the next, and the kernels are then held against their plain
    versions at the shapes that the long prefill and prefill_vs_decode's
    prefill and decode steps gave them (`check_path_shapes`).
    Last, flash_attention at head dim 256 timed beside SDPA
    (`time_flash_d256`).  Returns the launch counts of the no-grad
    forwards and the long prefills, summed, and the kernels' max abs
    errors at those shapes."""
    import dataclasses
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.distributed.serve_step import make_prefill
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    total = {k: 0 for k in KERNELS}
    path_err = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for arch in ALL_ARCHS:
        t_arch = time.time()
        cfg = get_config(arch).replace(num_layers=ARCH_LAYERS.get(arch, 1))
        model = build_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        want = {k: 0 for k in KERNELS} | forward_kernel_launches(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        # an SSD config's full-sequence forward takes a multiple of its chunk
        chunk = cfg.ssm.chunk_size if cfg.ssm is not None else 0
        n = chunk or 100
        tokens = torch.randint(0, cfg.vocab_size, (2, n), device=dev, generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (2, n), device=dev, generator=gen)
        front = frontend_inputs(cfg, 2, gen, dev)
        batch = {"tokens": tokens, "labels": labels, **front}
        plain = float(model.loss(params, batch)[0])
        ops.reset_launch_counts()
        with torch.no_grad():
            fast = float(model.loss(params, batch)[0])
        launches = ops.launch_counts()
        if launches != want:
            raise AssertionError(f"{arch}: no-grad forward launched {launches}, "
                                 f"expected {want}")
        if not close(fast, plain, EVAL_RTOL):
            raise AssertionError(f"{arch}: no-grad loss {fast} vs plain {plain}")
        for k in KERNELS:
            total[k] += launches[k]
        # prefill vs decode: a prefill row drops the pairs over its capacity
        # that a one-token decode row keeps, so MoE runs where none drops
        check = model if cfg.moe is None else build_model(cfg.replace(
            moe=dataclasses.replace(cfg.moe,
                                    capacity_factor=float(cfg.moe.num_experts))))
        with recorded_kernel_calls(ops) as short_calls:
            errs = prefill_vs_decode(check, params, tokens[:, :chunk or ARCH_CHECK_LEN],
                                     front, dev)
        if max(errs.values()) > SERVE_REL:
            raise AssertionError(f"{arch}: prefill vs streamed decode {errs} > {SERVE_REL}")
        # the long prefill, at the published capacity
        b, t = ARCH_PREFILL.get(arch, (0, 0))
        long_run = {}
        calls = {"flash_attention": [], "rmsnorm": []}
        if b:
            prompt = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), device=dev,
                                              generator=gen),
                      **frontend_inputs(cfg, b, gen, dev)}
            npfx = prompt["patch_embeds"].shape[1] if "patch_embeds" in prompt else 0
            prefill = make_prefill(model)
            ms = []
            for run in range(3):
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # the first run notes the kernels' shapes and options
                with (recorded_kernel_calls(ops) if run == 0
                      else contextlib.nullcontext(calls)) as calls:
                    logits, _ = prefill(params, prompt)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                launches = ops.launch_counts()
                if launches != want:
                    raise AssertionError(f"{arch}: prefill {b} x {t} launched "
                                         f"{launches}, expected {want}")
                if (logits.shape != (b, cfg.vocab_size)
                        or not torch.isfinite(logits).all()):
                    raise AssertionError(f"{arch}: prefill logits are not finite "
                                         "of the expected shape")
                del logits
            for k in KERNELS:
                total[k] += launches[k]
            flops = prefill_gemm_flops(cfg, b, npfx + t)
            long_run = dict(prefill_batch=b, prefill_tokens=npfx + t, prefix_tokens=npfx,
                            prefill_ms=ms,
                            prefill_tok_per_s=b * (npfx + t) / (min(ms) / 1e3),
                            prefill_gemm_tflop=flops / 1e12,
                            prefill_gemm_tflop_per_s=flops / 1e12 / (min(ms) / 1e3),
                            prefill_launches=launches)
        say("archs", nvidia_smi=smi, arch=arch, layers=cfg.num_layers,
            kinds=list(cfg.prefix_pattern + cfg.block_pattern * cfg.num_repeats),
            params=n_params, param_bytes=4 * n_params, head_dim=cfg.head_dim,
            launches_per_forward=want, eval_loss={"no_grad": fast, "plain": plain},
            rtol=EVAL_RTOL, rel_tol=SERVE_REL, rel_errs=errs, **long_run,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            seconds=round(time.time() - t_arch, 3))
        del params, model, check
        gc.collect()
        torch.cuda.empty_cache()
        # the kernels at the shapes of the long prefill and of the short
        # prefill and decode steps (whisper's cross-attention: one query
        # over 1500 frames), the model freed
        for k, keys in short_calls.items():
            calls[k] += [c for c in keys if c not in calls[k]]
        for k, e in check_path_shapes(calls, dev).items():
            path_err[k] = max(path_err[k], e)
        torch.cuda.empty_cache()
    say("archs", nvidia_smi=smi, flash_d256=time_flash_d256(
        dev, mem_bw(torch.cuda.get_device_name(0))))
    torch.cuda.empty_cache()
    return total, path_err


def moe_on_card(smi, ops, dev):
    """Phase moe: two identical forward and backward passes of each MoE
    smoke config give the same gradient bits; then ACCUM-NORM through the
    loop (MOE_TRAIN_JOB) on the card and on the CPU from the same
    parameters: the batch trajectory equal, the losses and var_l1 within
    REF_RTOL, one `fused_adamw_stats` a step per dtype group on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.launch.train import TrainJob, run_training
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    for arch in MOE_SMOKE:
        model = model_mod.build_model(get_smoke_config(arch))
        params = model.init(0, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        tokens = torch.randint(0, model.cfg.vocab_size, (8, 257), device=dev,
                               generator=gen)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        leaves, treedef = tree_flatten(params)

        def grads():
            xs = [x.detach().clone().requires_grad_(True) for x in leaves]
            loss = model.loss(tree_unflatten(treedef, xs), batch)[0]
            return loss, torch.autograd.grad(loss, xs)

        (l1, g1), (l2, g2) = grads(), grads()
        same = [torch.equal(a, b) for a, b in zip(g1, g2)]
        if not all(same) or not torch.equal(l1, l2):
            raise AssertionError(f"{arch}: repeated gradients differ in "
                                 f"{same.count(False)} of {len(same)} leaves")
        say("moe", arch=arch, tokens=list(batch["tokens"].shape), loss=l1.item(),
            leaves=len(g1), bit_identical=True)
        del params, g1, g2, leaves

    job = dict(MOE_TRAIN_JOB)
    cpu_params = model_mod.build_model(get_smoke_config(job["arch"])).init(0, "cpu")
    # the card's generator draws other numbers than the CPU's from one
    # seed, so both runs start from the CPU's draw
    real_init = model_mod.Model.init
    model_mod.Model.init = lambda self, seed=0, device=None: tree_map(
        lambda x: x.to(device, copy=True), cpu_params)
    try:
        cpu = run_training(TrainJob(**job, device="cpu"))
        ops.reset_launch_counts()
        card = run_training(TrainJob(**job, device=str(dev)))
        launches = ops.launch_counts()
    finally:
        model_mod.Model.init = real_init
    groups = adamw_groups(FlatLayout.from_tree(card["final_params"], device=dev))
    if launches != {k: 0 for k in KERNELS} | {"fused_adamw_stats": job["steps"] * groups}:
        raise AssertionError(f"MoE ACCUM-NORM launched {launches}")
    if card["global_batch"] != cpu["global_batch"]:
        raise AssertionError(f"batch trajectory: card {card['global_batch']} vs "
                             f"CPU {cpu['global_batch']}")
    for k in ("loss", "var_l1"):
        for a, b in zip(card[k], cpu[k]):
            if not close(a, b, REF_RTOL):
                raise AssertionError(f"MoE ACCUM-NORM {k}: card {card[k]} vs CPU {cpu[k]}")
    say("moe", nvidia_smi=smi, arch=job["arch"], step_impl="accum_norm",
        launches=launches, rtol=REF_RTOL, global_batch=card["global_batch"],
        loss={"cuda": card["loss"], "cpu": cpu["loss"]},
        var_l1={"cuda": card["var_l1"], "cpu": cpu["var_l1"]})
    return launches


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
    # the card's eager step (no graph) gives the graph's tokens too
    eager = run_serving(SERVE_ARCH, smoke=False, batch=2, prompt_len=16, gen_len=8,
                        params=params["cuda"], cuda_graphs=False)["tokens"]
    cpu, card = out["cpu"], out["cuda"]
    if not (eager == card[4]).all():
        raise AssertionError(f"run_serving tokens: graph {card[4].tolist()} vs "
                             f"eager {eager.tolist()} on the card")
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
        tokens=card[4].tolist(), graph_tokens_equal_eager_and_cpu=True)


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

    # run_serving: the decode step as one CUDA graph (its warm-up run, then
    # a replay a step) against the eager step, in turns; the same tokens
    per_step = 2 * layers + 1
    steps = SERVE_JOB["prompt_len"] + SERVE_JOB["gen_len"] - 1
    runs = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        torch.cuda.reset_peak_memory_stats()
        res, secs, launches = counted(lambda: run_serving(
            SERVE_ARCH, smoke=False, params=params, cuda_graphs=mode == "graph",
            **SERVE_JOB), "run_serving")
        want = {k: 0 for k in KERNELS} | {
            "rmsnorm": per_step * (steps + (mode == "graph"))}
        if launches != want:
            raise AssertionError(f"run_serving ({mode}) launched {launches}, "
                                 f"expected {want}")
        if res["tokens"].shape != (SERVE_JOB["batch"], SERVE_JOB["gen_len"]):
            raise AssertionError(f"run_serving tokens {res['tokens'].shape}")
        runs[mode].append(dict(res, wall_s=secs, launches=launches,
                               peak_mem_bytes=torch.cuda.max_memory_allocated()))
    tokens = [r["tokens"] for rs in runs.values() for r in rs]
    if not all((t == tokens[0]).all() for t in tokens):
        raise AssertionError("run_serving: the graph's and the eager step's greedy "
                             "tokens differ")
    say("serve", part="run_serving", nvidia_smi=smi, **SERVE_JOB,
        tokens_equal=True, **{f"{mode}_{k}": [r[k] for r in rs] for mode, rs in runs.items()
                             for k in ("prefill_s", "decode_s", "decode_tok_per_s",
                                       "launches", "peak_mem_bytes", "wall_s")},
        **{f"{mode}_decode_ms_per_step": [1e3 * r["decode_s"] / (SERVE_JOB["gen_len"] - 1)
                                          for r in rs] for mode, rs in runs.items()})
    for k in KERNELS:              # the eager runs are a yardstick, not the path
        total[k] -= sum(r["launches"][k] for r in runs["eager"])

    torch.cuda.reset_peak_memory_stats()
    res, secs, launches = counted(lambda: run_continuous_serving(
        SERVE_ARCH, smoke=False, params=params, **CONT_JOB), "continuous")
    eng = res["engine"]
    # every rung build is a capture after one warm-up run; every step a replay
    want = {k: 0 for k in KERNELS} | {"rmsnorm": per_step * (eng["steps"] + eng["compiles"])}
    if launches != want:
        raise AssertionError(f"continuous serving launched {launches}, expected {want}")
    if res["probe"]["new_compiles"] or eng["warmup_failures"]:
        raise AssertionError(f"continuous serving: {res['probe']}, {eng}")
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


def prefill_like(cfg, b: int, t: int) -> dict:
    """A prefill batch of b x t text tokens as meta tensors, with a vision
    config's patch embeddings or an audio config's frames."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    batch = {"tokens": meta((b, t), torch.int32)}
    if cfg.frontend.kind == "vision_stub":
        batch["patch_embeds"] = meta((b, cfg.frontend.num_prefix_tokens, cfg.d_model),
                                     cfg.act_dtype)
    elif cfg.frontend.kind == "audio_stub":
        batch["frames"] = meta((b, cfg.encoder.num_frames, cfg.d_model), cfg.act_dtype)
    return batch


def dryrun_phase(smi, ops, dev, plan) -> dict:
    """Phase dryrun: the dry-run (`repro_torch.launch.dryrun`) traces on fake
    CUDA tensors here and is held against what this run measures.
    (a) One ACCUM-NORM flat/flat step of full-width microllama-300m at
    `plan` (phase train's last (global batch, accumulation steps)) runs
    twice on the card, the peak statistics reset between the two; the
    trace's `peak_bytes` must be within DRYRUN_MEM_RTOL of the second
    run's `max_memory_allocated` (above what was allocated before the
    step was built), and its kernel calls must equal the second run's
    launches.  (b) Every registered config's prefill at ARCH_LAYERS and
    ARCH_PREFILL (the Llama family 1 layer at 4 x 2048): its traced
    `flash_attention` and `rmsnorm` calls equal `forward_kernel_launches`;
    llama3.2-1b's whole 16 layers at 4 x 2048: the traced FLOPs equal
    `prefill_gemm_flops` plus its 16 flash calls' (4·d a pair the causal
    mask admits), exactly.  (c) DRYRUN_COMBOS on a fake 256-rank group
    (16 x 16): memory, FLOPs, collective bytes by kind, the three terms
    and the bottleneck printed; the rank's parameter bytes must equal its
    specs' slices; with `--seqpar`, reduce-scatters on the model groups of
    16 and a lower peak than the same combination without.  Returns the
    phase's real launches."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.distributed.train_step import make_accum_norm_step
    from repro_torch.kernels.flash_attention import attended_pairs
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat

    t_phase = time.time()
    # (a) one ACCUM-NORM step: the trace's peak against the card's
    global_batch, accum = plan
    micro, seq = global_batch // accum, TRAIN_JOB["seq_len"]
    cfg = get_config(TRAIN_JOB["arch"])
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = model.init(0, dev)
    wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl="flat",
                                params_impl="flat", params_like=params, device=dev)
    layout = wrap.flat_layout
    opt = init_adamw_flat(params, layout=layout, device=dev)
    pb = tuple(layout.flatten(params))
    del params
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (accum, micro, seq), device=dev,
                              generator=gen).to(torch.int32) for k in ("tokens", "labels")}
    step = wrap(batch)
    pb, opt, met = step(pb, opt, batch, 1e-4)
    del met
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    pb, opt, met = step(pb, opt, batch, 1e-4)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    real_peak = torch.cuda.max_memory_allocated() - base
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    loss = float(met["loss"])
    del pb, opt, met, batch, step, wrap
    gc.collect()
    torch.cuda.empty_cache()
    like = {k: torch.empty((accum, micro, seq), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    tr, _ = dryrun.trace_train(cfg, like, None, dev, step_impl="accum_norm")
    gap = (tr.memory["peak_bytes"] - real_peak) / real_peak
    traced = {k: tr.kernel_calls[k] for k in KERNELS}
    say("dryrun", check="memory", arch=TRAIN_JOB["arch"], step_impl="accum_norm",
        global_batch=global_batch, accum=accum, seq_len=seq, loss=loss,
        step_s=round(step_s, 4), max_memory_allocated=real_peak,
        traced_peak_bytes=tr.memory["peak_bytes"], traced_memory=tr.memory,
        rel_gap=gap, limit=DRYRUN_MEM_RTOL, trace_s=round(tr.seconds, 3),
        traced_calls=traced, launches=launched, flops=tr.cost["flops"],
        flops_by_class=tr.cost["flops_by_class"])
    if abs(gap) > DRYRUN_MEM_RTOL:
        raise AssertionError(f"dry-run peak {tr.memory['peak_bytes']} vs the card's "
                             f"{real_peak}: {gap:+.3%}, limit {DRYRUN_MEM_RTOL:.0%}")
    if traced != launched:
        raise AssertionError(f"traced kernel calls {traced}, the step launched {launched}")

    # (b) every config's prefill: its kernel calls; llama3.2-1b's FLOPs
    for arch in ALL_ARCHS:
        cfg = get_config(arch).replace(num_layers=ARCH_LAYERS.get(arch, 1))
        b, t = ARCH_PREFILL.get(arch, (PREFILL_BATCH, PREFILL_LEN))
        tr, _ = dryrun.trace_prefill(cfg, prefill_like(cfg, b, t), None, dev)
        want = forward_kernel_launches(cfg)
        got = {k: tr.kernel_calls[k] for k in want}
        rl = roofline.roofline_terms(tr.cost)
        say("dryrun", check="forward", arch=arch, layers=cfg.num_layers, batch=b,
            tokens=t, calls=got, flops=tr.cost["flops"],
            gemm_flops=prefill_gemm_flops(cfg, b, t),
            flops_by_class=tr.cost["flops_by_class"],
            bytes_accessed=tr.cost["bytes accessed"], compute_ms=1e3 * rl.compute_s,
            memory_ms=1e3 * rl.memory_s, peak_bytes=tr.memory["peak_bytes"],
            trace_s=round(tr.seconds, 3))
        if got != want:
            raise AssertionError(f"{arch}: traced kernel calls {got}, expected {want}")
    cfg = get_config(SERVE_ARCH)
    b, t = PREFILL_BATCH, PREFILL_LEN
    tr, _ = dryrun.trace_prefill(cfg, prefill_like(cfg, b, t), None, dev)
    flash = 4 * cfg.head_dim * b * cfg.num_heads * attended_pairs(t, t, True, 0)
    want = prefill_gemm_flops(cfg, b, t) + cfg.num_layers * flash
    say("dryrun", check="prefill-flops", arch=SERVE_ARCH, batch=b, tokens=t,
        traced=tr.cost["flops"], gemm=prefill_gemm_flops(cfg, b, t),
        flash=cfg.num_layers * flash, flops_by_class=tr.cost["flops_by_class"],
        calls={k: tr.kernel_calls[k] for k in ("flash_attention", "rmsnorm")})
    if tr.cost["flops"] != want:
        raise AssertionError(f"traced prefill FLOPs {tr.cost['flops']}, expected {want}")
    # run_serving's decode step (batch 8, its last position), one process:
    # the bytes it moves against the card's memory rate
    n, cache_len = SERVE_JOB["batch"], SERVE_JOB["prompt_len"] + SERVE_JOB["gen_len"]
    specs = {"tokens": torch.empty(n, dtype=torch.int32, device="meta"), "ring": False,
             "cache": build_model(cfg).init_cache(n, cache_len, device="meta")}
    tr, _ = dryrun.trace_decode(cfg, specs, None, dev, cache_len - 1)
    rl = roofline.roofline_terms(tr.cost)
    say("dryrun", check="decode-bytes", arch=SERVE_ARCH, batch=n, cache_len=cache_len,
        bytes_accessed=tr.cost["bytes accessed"], memory_ms=1e3 * rl.memory_s,
        compute_ms=1e3 * rl.compute_s, flops_by_class=tr.cost["flops_by_class"],
        peak_bytes=tr.memory["peak_bytes"], calls={k: tr.kernel_calls[k] for k in
                                                  ("flash_attention", "rmsnorm")})

    # (c) production combinations on a fake 256-rank group
    recs = {}
    for arch, shape, seqpar in DRYRUN_COMBOS:
        _, rec = dryrun.lower_combo(arch, shape, multi_pod=False, seqpar=seqpar)
        recs[arch, shape, seqpar] = rec
        mem, rl = rec["memory"], rec["roofline"]
        say("dryrun", check="combo", arch=arch, shape=shape, mesh=rec["mesh"],
            step_impl=rec["step_impl"], seqpar=rec["seqpar"], nvidia_smi=smi,
            trace_s=rec["trace_s"],
            memory=mem, flops=rec["cost"]["flops"],
            flops_by_class=rec["cost"]["flops_by_class"],
            bytes_accessed=rec["cost"]["bytes accessed"],
            wire_bytes={k: v["result_bytes"] for k, v in rec["collectives"].items()},
            collectives={k: (v["count"], v["group_sizes"])
                         for k, v in rec["collectives"].items()},
            kernel_calls=rec["kernel_calls"], compute_s=rl["compute_s"],
            memory_s=rl["memory_s"], collective_s=rl["collective_s"],
            bottleneck=rl["bottleneck"])
        if mem["params_bytes"] != mem["param_spec_bytes"]:
            raise AssertionError(f"{arch} {shape}: the rank's parameters take "
                                 f"{mem['params_bytes']} B, its specs' slices "
                                 f"{mem['param_spec_bytes']}")
    for (arch, shape, seqpar), rec in recs.items():
        if not seqpar:
            continue
        rs = rec["collectives"]["reduce-scatter"]
        whole = recs[arch, shape, False]["memory"]["peak_bytes"]
        if (not rec["seqpar"] or not rs["count"] or set(rs["group_sizes"]) != {16}
                or rec["memory"]["peak_bytes"] >= whole):
            raise AssertionError(f"{arch} {shape} --seqpar: reduce-scatters {rs}, peak "
                                 f"{rec['memory']['peak_bytes']} against {whole}")
    say("dryrun", seconds=round(time.time() - t_phase, 3))
    return launched


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
# resume-fsdp's depth: at the full 12 layers the phase took 168-172 s (PERF.md §6);
# 2 since the dryrun phase joined and a slow host took 1073.2 s for the run
# with 4 (PERF.md §4)
RESUME_FSDP_LAYERS = 2
# resume-accum's depth: at the full 12 layers it took 95.1 s of a 986 s run
# (PERF.md §4, §6); 2 since the dryrun phase joined, as resume-fsdp's
RESUME_ACCUM_LAYERS = 2
# the resume-accum child: the train CLI with the config cut to `layers`
RESUME_CHILD = ("import sys\n"
                "from repro_torch.launch import train as T\n"
                "full = T.get_config\n"
                "T.get_config = lambda arch: full(arch).replace(num_layers={layers})\n"
                "T.main(sys.argv[1:])\n")
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
    """Phase resume-accum: full-width microllama-300m (RESUME_ACCUM_LAYERS
    of its 12 layers), ACCUM-NORM, flat stats and params.  An
    uninterrupted 6-step run (one checkpoint, at the end); the same job in
    a child process (the train CLI's `main`) with a checkpoint every 2
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
    from repro_torch.launch.train import TrainJob, run_training

    from repro_torch.launch import train as T

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    say("resume-accum", part="start", nvidia_smi=smi, tmpdir=tmp, free_bytes=free)
    timer = CheckpointTimer()
    full = T.get_config
    T.get_config = lambda arch: full(arch).replace(num_layers=RESUME_ACCUM_LAYERS)
    try:
        # repro: allow(unfenced-timing) — whole-run span; run_training materializes host floats every step, so the wall clock cannot run ahead of device work
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
        child = subprocess.run([sys.executable, "-c",
                                RESUME_CHILD.format(layers=RESUME_ACCUM_LAYERS),
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
        layers = RESUME_ACCUM_LAYERS
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
            phase_s=round(time.time() - t0, 3), free_bytes_before=free,
            layers=RESUME_ACCUM_LAYERS)
    finally:
        T.get_config = full
        timer.close()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def resume_fsdp_rank(job, root):
    """One rank of phase resume-fsdp: the uninterrupted 6-step run (one
    checkpoint, at the end), a 4-step run with a checkpoint every 2 steps,
    and a fresh `run_training(resume=True)` to step 6, in one process
    group, the config cut to RESUME_FSDP_LAYERS layers.  Returns rank 0's
    histories."""
    from repro_torch.launch import train as T
    from repro_torch.launch.train import TrainJob, run_training
    full = T.get_config
    T.get_config = lambda arch: full(arch).replace(num_layers=RESUME_FSDP_LAYERS)
    keep = ("loss", "global_batch", "samples", "var_l1", "val_loss",
            "resumed_from", "time", "ranks")
    runs = (("ref", dict(checkpoint_dir=f"{root}/ref")),
            ("first", dict(steps=4, checkpoint_dir=f"{root}/run",
                           checkpoint_every=2)),
            ("resumed", dict(checkpoint_dir=f"{root}/run", checkpoint_every=2,
                             resume=True)))
    out = {}
    for name, over in runs:
        # repro: allow(unfenced-timing) — whole-run span; run_training materializes host floats every step, so the wall clock cannot run ahead of device work
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
    from repro_torch.launch.mesh import spawn_workers

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    try:
        # repro: allow(unfenced-timing) — the span ends when its child processes have exited; nothing of this process is left in flight
        t0 = time.time()
        out = spawn_workers(resume_fsdp_rank, 2, RESUME_FSDP_JOB, tmp, backend="gloo")
        same_suffix(out["resumed"], out["ref"], 4)
        nbytes = same_checkpoint(f"{tmp}/ref", f"{tmp}/run", 6)
        layers = RESUME_FSDP_LAYERS
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
    # repro: allow(unfenced-timing) — whole-run span; every step's results are read back to the host before the next, so the wall clock cannot run ahead of device work
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


# phase coord: two file-coordinated processes on the card, smoke llama,
# ACCUM-NORM flat/flat across a stagewise 4 -> 8 increase, warm-up on
COORD_JOB = dict(arch="llama3.2-1b", smoke=True, schedule="stagewise",
                 stages="0.5:4,0.5:8", steps=12, total_samples=48, seq_len=16,
                 base_global_batch=4, max_global_batch=8, base_micro_batch=2,
                 max_micro_batch=2, base_accum=2, step_impl="accum_norm",
                 stats_impl="flat", params_impl="flat", eval_every=0,
                 aot_warmup=True, coord="file", coord_world=2, coord_timeout=120.0)


def coord_phase(smi):
    """Phase coord: `python -m repro_torch.launch.train` with `--coord file
    --aot-warmup --compile-cache`, children of this process on the card.
    (a) Two ranks train COORD_JOB: on both the 4 -> 8 increase is a
    transition hit, the only foreground build is the first rung, no
    desync, equal losses.  (b) A second job over the same compile cache
    loads its kernel library from disk (`disk_cache_hits` > 0) and builds
    nothing: the cache's libraries keep their inodes and times.  (c) The
    dead-rank survivor: rank 1 is SIGKILLed by the fault harness at step
    3; rank 0 exits with a `CoordinationError` naming rank 1 dead at the
    step-7 rung entry, after checkpointing step 6."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint.store import latest_step

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_coord_"))
    cache = tmp / "compile-cache"
    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    env.update(PYTHONPATH=str(ROOT / "src"), REPRO_COORD_HEARTBEAT_S="0.1",
               REPRO_COORD_DEAD_AFTER_S="2.0")

    def start(job, extra_env=None):
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                                 *cli_args(job)], cwd=ROOT, env={**env, **(extra_env or {})},
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(proc, what):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"{what} failed ({proc.returncode}):\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
        return json.loads(out[out.index("{"):])

    def libraries():
        return {p.relative_to(cache).as_posix(): (p.stat().st_ino, p.stat().st_mtime_ns)
                for p in cache.rglob("*.so")}

    # repro: allow(unfenced-timing) — the span ends when its child processes have exited; nothing of this process is left in flight
    t0 = time.time()
    try:
        job = dict(COORD_JOB, coord_dir=str(tmp / "coord-a"), compile_cache=str(cache))
        procs = [start(dict(job, coord_rank=r)) for r in range(2)]
        two = [finish(p, f"coordinated rank {r}") for r, p in enumerate(procs)]
        for r, summary in enumerate(two):
            eng = summary["engine"]
            if not (eng["transitions"] == eng["transition_hits"] == 1
                    and eng["compiles"] - eng["warmups"] == 1 and eng["desyncs"] == 0):
                raise AssertionError(f"rank {r}: the increase was not a warmed hit: {eng}")
        if two[0]["best_loss"] != two[1]["best_loss"]:
            raise AssertionError(f"the ranks' losses differ: {two}")
        built = libraries()
        if not built:
            raise AssertionError(f"no kernel library in the compile cache {cache}")
        t1 = time.time()
        again = finish(start(dict(job, coord_dir=str(tmp / "coord-b"), coord_world=1,
                                  coord_rank=0)), "the run over the warm cache")
        again_s = time.time() - t1
        if again["engine"]["disk_cache_hits"] < 1 or libraries() != built:
            raise AssertionError(f"the second run did not load the cached libraries: "
                                 f"{again['engine']}, {built} -> {libraries()}")
        ck = tmp / "ck"
        dead = dict(job, coord_dir=str(tmp / "coord-c"))
        procs = [start(dict(dead, coord_rank=0, checkpoint_dir=str(ck))),
                 start(dict(dead, coord_rank=1), {"REPRO_FAULTS": json.dumps(
                     [{"site": "train.step", "at": 3, "action": "die"}])})]
        out0, err0 = procs[0].communicate(timeout=300)
        _, err1 = procs[1].communicate(timeout=300)
        if procs[1].returncode != -9:
            raise AssertionError(f"rank 1 was to die by SIGKILL: {procs[1].returncode}\n"
                                 f"{err1[-3000:]}")
        if (procs[0].returncode == 0 or "CoordinationError" not in err0
                or "dead ranks (stale heartbeat): [1]" not in err0):
            raise AssertionError(f"rank 0 did not fail with a CoordinationError naming "
                                 f"rank 1 ({procs[0].returncode}):\n{err0[-3000:]}")
        if latest_step(str(ck)) != 6:
            raise AssertionError(f"rank 0's latest checkpoint is {latest_step(str(ck))}, "
                                 "not 6")
        blame = next(line for line in reversed(err0.splitlines())
                     if "CoordinationError:" in line)
        say("coord", nvidia_smi=smi, ranks=[s["engine"] for s in two],
            best_loss=two[0]["best_loss"], cached_libraries=sorted(built),
            warm_cache_run={"engine": again["engine"], "seconds": round(again_s, 3)},
            dead_rank={"rank1_exit": procs[1].returncode, "rank0_exit": procs[0].returncode,
                       "error": blame.strip(), "latest_checkpoint": 6},
            seconds=round(time.time() - t0, 3))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def analysis_phase(smi) -> dict:
    """Phase analysis: the static-analysis gate (`repro_torch.analysis`) on
    fake CUDA tensors, the kernels' custom ops and their fake
    implementations on the card's route.  The invariant checks, the cost
    budget's exact metrics (op counts, collective bytes, FLOPs, in-place
    count; the peak is printed beside the budget's CPU figure, not gated)
    and the divergence checks must leave no unwaived finding, and each
    variant's layout counts and collective signature on "cuda" must equal
    the CPU trace's in this run: the kernel route and the plain route
    pack and reduce the same things.  Nothing is launched; the traced
    kernel calls are printed as calls."""
    from repro_torch.analysis.costmodel import BUDGET_PATH, load_budget, run_cost_checks
    from repro_torch.analysis.divergence import collective_signature, run_divergence_checks
    from repro_torch.analysis.findings import active
    from repro_torch.analysis.invariants import build_variants, run_invariant_checks

    # repro: allow(unfenced-timing) — fake tensors: the traces run on the host, nothing on the card
    t0 = time.time()
    on_cpu, on_card = build_variants(), build_variants()
    cpu_findings, cpu_checked = run_invariant_checks(variants=on_cpu, device="cpu")
    t_cpu = time.time() - t0
    findings, checked = run_invariant_checks(variants=on_card, device="cuda")
    cost, cost_checked = run_cost_checks(BUDGET_PATH, variants=on_card, device="cuda")
    div, _ = run_divergence_checks(on_card, device="cuda")
    bad = active(cpu_findings + findings + cost + div)
    if bad:
        raise AssertionError("analysis findings on the card:\n"
                             + "\n".join(f.render() for f in bad))
    budget = load_budget(BUDGET_PATH)["variants"]
    rows = {}
    for vc, vg in zip(on_cpu, on_card, strict=True):
        st_cpu, st_card = vc.traces[("cpu", 0)][1], vg.traces[("cuda", 0)][1]
        if cpu_checked["layout_counts"][vc.name] != checked["layout_counts"][vg.name]:
            raise AssertionError(f"{vc.name}: layout counts on the card "
                                 f"{checked['layout_counts'][vg.name]} != the CPU's "
                                 f"{cpu_checked['layout_counts'][vc.name]}")
        if collective_signature(st_cpu) != collective_signature(st_card):
            raise AssertionError(f"{vc.name}: the card's collective signature differs "
                                 f"from the CPU's")
        m = cost_checked["metrics"][vg.name]
        rows[vg.name] = {"layout": checked["layout_counts"][vg.name],
                         "collectives": m["collectives"], "flops": m["flops"],
                         "inplace": m["inplace"], "cuda_peak_bytes": m["peak_bytes"],
                         "cpu_peak_bytes": budget[vg.name]["peak_bytes"],
                         "traced_kernel_calls": st_card.kernel_calls,
                         "trace_s": round(st_card.seconds, 3)}
    seconds = round(time.time() - t0, 1)
    say("analysis", nvidia_smi=smi, variants=rows, waived=sum(f.waived for f in cost + div),
        cpu_trace_s=round(t_cpu, 1), seconds=seconds)
    return rows


# the examples' runs on the card: (example, arguments)
EXAMPLE_RUNS = (("torch_pretrain_e2e", ["--full", "--steps", "4"]),
                ("torch_serve_batched", []),
                ("torch_quickstart", ["--steps", "6"]),
                ("torch_gns_tracking", ["--steps", "6"]))


def examples_phase(smi, ops) -> dict:
    """Phase examples: the port's examples through their `main`, on the
    card, in a temporary working directory (their `experiments/` outputs
    and the e2e job's checkpoint go there and are removed).
    `torch_pretrain_e2e.py --full` trains full-width microllama-300m
    (ACCUM-NORM, flat stats and params) for a few steps: one
    `fused_adamw_stats` launch a step per dtype group, no other tail
    kernel; `torch_serve_batched.py` serves gemma2 smoke through
    `run_serving` (the prompt streamed through the decode graph: rmsnorm
    launches, the decode's attention plain); quickstart and gns_tracking
    run a few steps.  Each one's summary, launches and seconds are printed;
    the launches are returned."""
    import importlib.util
    import shutil
    import tempfile
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.launch.train import summarize

    total = {k: 0 for k in KERNELS}
    out = {}
    here, work = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        os.chdir(work)
        for name, argv in EXAMPLE_RUNS:
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            ops.reset_launch_counts()
            t0 = time.time()
            res = mod.main(argv)
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = ops.launch_counts()
            total = {k: total[k] + launches[k] for k in KERNELS}
            if name == "torch_serve_batched":
                # the prompt streams through decode, whose attention is the
                # plain grouped one: rmsnorm's kernel, no flash
                if not launches["rmsnorm"] or launches["flash_attention"]:
                    raise AssertionError(f"serving launched {launches}")
                summary = {"tokens_shape": list(res["tokens"].shape),
                           "decode_tok_per_s": res["decode_tok_per_s"]}
            else:
                if not all(map(math.isfinite, res["loss"])):
                    raise AssertionError(f"{name}: losses {res['loss']}")
                summary = summarize(res)
            if name == "torch_pretrain_e2e":
                layout = FlatLayout.from_tree(res["final_params"], device="cuda")
                want = len(res["step"]) * adamw_groups(layout)
                if (launches["fused_adamw_stats"] != want or launches["fused_adamw"]
                        or launches["fused_stats"] or launches["sqdiff_norm"]):
                    raise AssertionError(f"e2e --full launched {launches}, expected "
                                         f"{want} fused_adamw_stats and no other "
                                         f"tail kernel")
                summary["params"] = sum(layout.buffer_sizes)
                summary["global_batch"] = res["global_batch"]
            out[name] = {"argv": argv, "seconds": round(secs, 2),
                         "launches": launches, "summary": summary}
            del res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    say("examples", nvidia_smi=smi, runs=out)
    return total


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
    from repro_torch.kernels.buckets import TABLES
    from repro_torch.kernels.sqdiff_norm import sqdiff_norm

    t_start = time.time()
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Seconds since the previous lap, under `name` (the total line)."""
        now = time.time()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

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

    lap("build")
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
    lap("check")
    arch_launches, arch_err = check_archs(smi, ops, dev)
    lap("archs")
    moe_on_card(smi, ops, dev)

    lap("moe")
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

    lap("ref")
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
        # the flat tail: one launch a step of each list kernel per dtype
        # group; the tree routes likewise, over every leaf (the statistic's
        # check is one call over f32 g_j and g)
        want = {"flat": zero | {"fused_stats": steps,
                                "fused_adamw_stats": steps * out["flat/cuda"]["adamw_groups"]},
                "tree": zero | {"fused_adamw": steps * out["tree/cuda"]["param_dtypes"],
                                "sqdiff_norm": 1}}
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
                  for r in ranks],
        tree_leaves=ranks[0]["tree/cuda"]["leaves"],
        table_builds_hits=[{k: (v["table_builds"], v["table_hits"])
                            for k, v in r.items() if k.endswith("cuda")} for r in ranks])

    lap("fsdp-ref")
    # serve-ref: serving, card against CPU, llama3.2-1b full width, 2 layers
    serve_ref(smi)

    lap("serve-ref")
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
    hist_plan = {"global_batch": hist["global_batch"][-1],
                 "accum": hist["accum_steps"][-1]}
    del hist
    gc.collect()
    torch.cuda.empty_cache()       # the ranks below need the card's memory

    lap("train")
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

    lap("fsdp")
    # mesh: the model axis, a data x model grid of gloo ranks ------------------
    mesh_launches, mesh_err, seqpar_runs = mesh_phase(smi, ops, dev)
    lap("mesh")
    # mesh-kinds: the MoE, MLA, SSD and RG-LRU layers on the model axis ---------
    kinds_launches, kinds_err = mesh_kinds_phase(smi, ops, dev)

    lap("mesh-kinds")
    # seqpar: sequence parallelism in the FSDP-Norm step (mesh's ranks ran it)
    sp_launches, sp_err = seqpar_phase(smi, ops, dev, seqpar_runs)
    lap("seqpar")
    # serve: serving's main path, full-width llama3.2-1b -----------------------
    serve_launches = serve_path(smi, ops, dev)

    lap("serve")
    # dryrun: the trace of one rank's step held against this run -------------
    dryrun_phase(smi, ops, dev, (hist_plan["global_batch"], hist_plan["accum"]))
    lap("dryrun")
    # serve-mesh: serving on a data x model grid, every layer kind ------------
    sm_launches, sm_err = serve_mesh_phase(smi, ops, dev)
    lap("serve-mesh")
    # analysis: the static-analysis gate on fake CUDA tensors ----------------
    analysis_phase(smi)
    lap("analysis")
    # examples: the port's examples on the card --------------------------------
    ex_launches = examples_phase(smi, ops)
    lap("examples")
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
    del copies
    # the tree routes over the layout's 98 tensors, as the per-tensor
    # kernels' callers reach them: one launch each per dtype group, held
    # against the plain versions tensor by tensor, and a second call on
    # copies of the same inputs the same bits; lr comes from the host, as
    # the schedule makes it
    tree_kw = dict(lr=torch.tensor(3e-4), c1=scal[1], c2=scal[2], **hyper)
    twice = [[[x.clone() for x in xs] for xs in (pb, mb, vb)] for _ in range(2)]
    builds0, hits0 = TABLES.builds, TABLES.hits
    ops.reset_launch_counts()
    sq = [ops.sqdiff_norm_tree(mb, gb) for _ in range(2)]
    for p_, m_, v_ in twice:
        ops.fused_adamw_tree(p_, gb, m_, v_, **tree_kw)
    tree_route = {"launches": ops.launch_counts(), "table_builds": TABLES.builds - builds0,
                  "table_hits": TABLES.hits - hits0}
    if tree_route["launches"] != {k: 0 for k in KERNELS} | {"sqdiff_norm": 2,
                                                            "fused_adamw": 2}:
        raise AssertionError(f"tree routes over the layout launched {tree_route}")
    if not torch.equal(sq[0], sq[1]) or not all(
            torch.equal(a, b) for xa, xb in zip(*twice) for a, b in zip(xa, xb)):
        raise AssertionError("the tree routes' two calls differ in their bits")
    want_sq = torch.zeros((), device=dev)
    for i, (p, g, m, v) in enumerate(bufs):
        w = ref.adamw_ref(p, g, m, v, **ref_kw)
        for got, expect in zip((twice[0][0][i], twice[0][1][i], twice[0][2][i]), w):
            torch.testing.assert_close(got, expect, **tol[f32])
            err["fused_adamw"] = max(err["fused_adamw"], float((got - expect).abs().max()))
        want_sq += ref.sqdiff_norm_ref(m, g)
        del w
    torch.testing.assert_close(sq[0], want_sq, rtol=sum_rtol, atol=0.0)
    err["sqdiff_norm"] = max(err["sqdiff_norm"], float((sq[0] - want_sq).abs()))
    err = {k: max(e, list_err.get(k, 0.0)) for k, e in err.items()}
    del twice
    gc.collect()

    over_layout = lambda fn: (lambda: [fn(*b) for b in bufs])
    lists = {"fused_adamw_stats": lambda: fused_adamw_stats_buckets(pb, gb, mb, vb, scal,
                                                                    **hyper),
             "fused_stats": lambda: fused_stats_buckets(mb, gb),
             # the tree routes, the scalars' host upload included
             "fused_adamw": lambda: ops.fused_adamw_tree(pb, gb, mb, vb, **tree_kw),
             "sqdiff_norm": lambda: ops.sqdiff_norm_tree(mb, gb)}
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
        # the four streaming kernels: the one list or tree call (ms)
        # against the earlier calling pattern, one call a bucket or tensor
        # (per_bucket_ms), and the library, in turns
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
    # the other kernels' at the main path's, and at the shapes the archs
    # phase's long prefills gave them (the sweeps print their own)
    serve_timed = time_serving_kernels(dev, bw)
    err.update({k: max(t["max_abs_err"], arch_err[k]) for k, t in serve_timed.items()})
    timed.update(serve_timed)
    # the share of the byte bound each streaming loop reaches on one bucket
    t_big["fused_adamw_stats_share"] = t_big["adamw_bound_ms"] / t_big["fused_adamw_stats_ms"]
    t_big["fused_stats_share"] = t_big["stats_bound_ms"] / t_big["fused_stats_ms"]
    say("time", nvidia_smi=smi, elements=n_total, buckets=len(sizes), kernels=timed,
        tree_route=tree_route,
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
    lap("time")
    estimators(smi, dev)
    lap("estimators")
    mixed_and_local(smi, ops, dev)
    lap("mixed, local-sgd")
    coord_phase(smi)
    lap("coord")
    resume_accum(smi, ops, layout)
    lap("resume-accum")
    resume_fsdp(smi, fsdp_layout)
    lap("resume-fsdp")
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
    # ones, serving's path (prefill, run_serving, continuous) and the archs
    # phase's forwards and prefills for the rest
    path_launches = {**fsdp_launches, **tree_launches,
                     **{k: serve_launches[k] + arch_launches[k]
                        for k in ("rmsnorm", "flash_attention")}}
    # and the mesh phase's 2 x 2 grid, mesh-kinds', seqpar's and serve-mesh's
    # runs (every rank), and the examples'
    path_launches = {k: n + mesh_launches[k] + kinds_launches[k] + sp_launches[k]
                     + sm_launches[k] + ex_launches[k] for k, n in path_launches.items()}
    err = {k: max(e, mesh_err.get(k, 0.0), kinds_err.get(k, 0.0), sp_err.get(k, 0.0),
                  sm_err.get(k, 0.0))
           for k, e in err.items()}
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
    say("total", seconds=round(time.time() - t_start, 3), phase_seconds=laps)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def phase_alone(phase: str, layers: int | None) -> int:
    """`python3 chip_smoke.py mesh|mesh-kinds|seqpar|serve-mesh|dryrun|
    analysis|examples [layers]`: the device, the build and that phase alone
    (mesh and seqpar at `layers` layers, mesh-kinds with mamba2 at
    `layers`; dryrun at DRYRUN_PLAN), nothing else (no result line)."""
    global MESH_LAYERS, SEQPAR_LAYERS
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))
    if phase == "dryrun":
        dryrun_phase(smi, ops, torch.device("cuda"), DRYRUN_PLAN)
    elif phase == "analysis":
        analysis_phase(smi)
    elif phase == "examples":
        examples_phase(smi, ops)
    elif phase == "mesh":
        MESH_LAYERS = layers or MESH_LAYERS
        mesh_phase(smi, ops, torch.device("cuda"))
    elif phase == "seqpar":
        SEQPAR_LAYERS = layers or SEQPAR_LAYERS
        seqpar_phase(smi, ops, torch.device("cuda"))
    elif phase == "serve-mesh":
        serve_mesh_phase(smi, ops, torch.device("cuda"))
    else:
        KINDS_LAYERS["mamba2-370m"] = layers or KINDS_LAYERS["mamba2-370m"]
        mesh_kinds_phase(smi, ops, torch.device("cuda"))
    left = child_processes()
    if left:
        raise AssertionError(f"processes the run started are still there: {left}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["mesh"], ["mesh-kinds"], ["seqpar"], ["serve-mesh"], ["dryrun"],
                         ["analysis"], ["examples"]):
        sys.exit(phase_alone(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None))
    sys.exit(main())
