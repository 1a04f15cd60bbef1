"""Training loop: adaptive / constant / stagewise batch-size pretraining
(counterpart of `repro/launch/train.py`).

Usable as a library (`run_training(TrainJob(...))`) and as a CLI:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch microllama-300m --schedule adaptive --step-impl accum_norm \
        --stats-impl flat --params-impl flat --steps 20 --seq-len 512

The loop is Algorithm 1: for each step the controller's BatchPlan
determines the (M, J*micro, seq) stacked batch; the step accumulates over
M, computes the norm-test statistic and runs the AdamW update; the host
controller consumes (var_l1, grad_sqnorm) and emits the next plan.

The mesh is J = `mesh_data` data workers by M = `mesh_model` ranks of
tensor parallelism, one process per rank, J·M in all, in row-major order
over (data, model) (`launch/mesh.py`): inside a process group (e.g. under
`torchrun`) as this process's rank, otherwise it spawns J·M local ranks
and returns rank 0's history.  Both steps run on it: FSDP-Norm's workers
are the data coordinates, and ACCUM-NORM's microbatches span them; the
BatchPlan's workers are J.  Every rank runs the same loop and controller
on the same metrics, so all take the same batch-size decisions.  NCCL
needs a card per rank; ranks that share a card or run on the CPU name
`--dist-backend gloo` (the CPU's default).

Crash-safe training (DESIGN §12): `checkpoint_every` > 0 writes a
crash-atomic checkpoint (params/opt + controller state + samples cursor)
every N steps, in the reference's on-disk layout (`checkpoint/store.py`),
and `resume` restarts from the newest complete checkpoint in
`checkpoint_dir`, reproducing the uninterrupted run's losses bit for bit.
On a mesh rank 0 writes the WHOLE state (flat shards and tree slices
gathered first), so a checkpoint crosses mesh shapes, and every rank
takes its own slices back on resume.

Multi-host coordination (DESIGN §8.1): `coord` "file" (a shared
directory, `coord_dir`) or "distributed" (the process group) puts
rung-entry barriers and a leader-decided warm-up agreement into the
bucketed engine; `aot_warmup` builds the rung the controller is headed to
on the engine's worker; `compile_cache` keeps the kernels' libraries in a
directory that restarted workers load instead of running nvcc.  A rank
that finds a peer dead checkpoints and re-raises the `CoordinationError`.

Runs on the CUDA card unless the job asks for the CPU (`device="cpu"`,
`--device cpu`).  With no device given and no card present it raises; it
never falls back to the CPU.  On the card, float32 matmuls and
convolutions stay float32 (TF32 off), as on the reference's CPU runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import (
    FLAT_PARAMS_META, flat_params_metadata, latest_step, restore_checkpoint,
    save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.controller import (
    ControllerConfig, controller_state_as_dict, controller_state_from_dict,
    init_controller, controller_update)
from repro_torch.core.schedule import (
    BatchPlan, ConstantSchedule, StagewiseSchedule, accum_free_plan,
    bucket_ladder, parse_ladder, round_plan)
from repro_torch.data.pipeline import (
    MarkovTokens, UniformTokens, make_batch, pad_to_bucket)
from repro_torch.distributed.coordination import (
    CoordinationError, enable_persistent_cache, make_coordinator)
from repro_torch.distributed.engine import BucketedEngine
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.distributed.params import gather_tree, shard_tree
from repro_torch.distributed.sharding import (
    TP_STATS, gather_flat_buffers, reset_tp_stats, shard_flat_buffers)
from repro_torch.distributed.train_step import (
    batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.kernels.ops import launch_counts
from repro_torch.launch.mesh import (
    data_axes, default_backend, init_workers, make_host_mesh, num_workers,
    rank_device, spawn_workers)
from repro_torch.models.common import resolve_device
from repro_torch.models.convert import stack_layers, unstack_layers
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import (
    AdamWConfig, init_adamw, init_adamw_flat, warmup_cosine)
from repro_torch.testing.faults import fault_point
from repro_torch.tree import tree_map


@dataclass
class TrainJob:
    arch: str = "microllama-300m"
    smoke: bool = True
    schedule: str = "adaptive"            # adaptive | constant | stagewise
    step_impl: str = "fsdp_norm"          # fsdp_norm | accum_norm
    variance_impl: str = "scalar"         # scalar | paper (FSDP-Norm only)
    stats_impl: str = "tree"              # tree | flat (DESIGN §9 buffers)
    params_impl: str = "tree"             # tree | flat (DESIGN §10 resident)
    eta: float = 0.2
    steps: int = 200
    total_samples: int | None = None      # stop criterion (paper trains by samples)
    seq_len: int = 128
    base_global_batch: int = 16
    max_global_batch: int = 256
    base_micro_batch: int = 2
    max_micro_batch: int = 4
    base_accum: int = 2
    test_interval: int = 1
    ema: float = 0.0
    # predictive GNS companion (DESIGN §14): a pure observer — the batch
    # trajectory is identical with predict on or off
    predict: bool = False
    gns_alpha: float = 0.9
    slope_alpha: float = 0.5
    predict_horizon: int = 5
    # accumulation-free low rungs (DESIGN §14): rungs with global batch <=
    # accum_free_below run as M=1 plans `M` times (0 = workers*max_micro)
    accum_free: bool = False
    accum_free_below: int = 0
    stages: tuple = ((0.025, 16), (0.025, 64), (0.95, 256))
    peak_lr: float = 4e-4
    min_lr: float = 4e-5
    warmup_frac: float = 0.01
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    data: str = "markov"                  # markov | uniform
    data_seed: int = 0
    seed: int = 0
    # J data-parallel workers by mesh_model ranks of tensor parallelism,
    # one process a rank; mesh_data 0 = the launcher's world size
    # (torchrun) over mesh_model, else 1
    mesh_data: int = 0
    mesh_model: int = 1
    dist_backend: str = ""                # "" = nccl on the card, gloo on the CPU
    seq_stages: tuple = ()
    bucket_ladder: str = "auto"           # auto | off | 'micro:accum,...'
    aot_warmup: bool = False
    coord: str = "none"
    coord_dir: str = ""
    coord_rank: int = -1
    coord_world: int = 0
    coord_timeout: float = 120.0
    compile_cache: str = ""
    eval_every: int = 25
    eval_batches: int = 4
    checkpoint_dir: str = ""
    # crash-safe training (DESIGN §12): checkpoint_every > 0 saves every N
    # steps; resume restarts from the newest complete checkpoint
    checkpoint_every: int = 0
    resume: bool = False
    log_path: str = ""
    device: str = ""                      # "" = the CUDA card; or "cpu"


def _world(job: TrainJob) -> int:
    """The ranks of the job: the process group's, else the launcher's,
    else J·M from the job."""
    if num_workers() > 1:
        return num_workers()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return max(job.mesh_data, 1) * job.mesh_model


def _workers(job: TrainJob) -> int:
    """J: `mesh_data`, else the world over `mesh_model`."""
    return job.mesh_data or _world(job) // job.mesh_model


def _check_supported(job: TrainJob):
    if job.step_impl not in ("fsdp_norm", "accum_norm"):
        raise ValueError(f"step_impl must be 'fsdp_norm' or 'accum_norm', "
                         f"got {job.step_impl!r}")
    world = _world(job)
    if job.mesh_model < 1 or world % job.mesh_model:
        raise ValueError(f"mesh_model {job.mesh_model} does not divide the "
                         f"world of {world} ranks")
    if _workers(job) * job.mesh_model != world:
        raise ValueError(f"a mesh of {_workers(job)} x {job.mesh_model} needs "
                         f"{_workers(job) * job.mesh_model} ranks, the world "
                         f"has {world}")


def _make_source(job: TrainJob, vocab: int):
    if job.data == "markov":
        return MarkovTokens(vocab_size=vocab, seed=job.data_seed)
    return UniformTokens(vocab_size=vocab, seed=job.data_seed)


class _CheckpointLayout:
    """How the training state is written: in the reference's layout, so a
    checkpoint crosses between the packages.  Layers are stacked
    (`models/convert.py::stack_layers`) and flat buffers are packed over
    that stacked tree at this job's bucket size and worker count; the
    metadata records that recipe, as the reference's does.  Converting
    both ways is slicing and copying only, so a restore is bit-exact."""

    def __init__(self, cfg, layout, params_tree, flat_params: bool,
                 flat_opt: bool, device, mesh=None, tree_specs=None):
        self.cfg, self.layout, self.device = cfg, layout, device
        self.flat_params, self.flat_opt = flat_params, flat_opt
        # tree leaves rest as this rank's slices on a grid (`tree_specs`)
        self.mesh, self.tree_specs = mesh, tree_specs
        meta = tree_map(lambda x: torch.empty_like(x, device="meta"),
                        params_tree)
        self.ref_meta = stack_layers(meta, cfg)
        self.ref_layout = (FlatLayout.from_tree(
            self.ref_meta, bucket_bytes=layout.bucket_bytes,
            shard_divisor=layout.shard_divisor) if layout is not None else None)

    def to_reference(self, params, opt_state, rank: int):
        """The whole state, host tensors, on rank 0 (None on the others);
        every rank must call it, since it gathers the flat shards and the
        tree slices."""
        parts = [(params, self.flat_params), (opt_state["m"], self.flat_opt),
                 (opt_state["v"], self.flat_opt)]
        parts = [(gather_flat_buffers(list(x), mesh=self.mesh) if flat
                  else self.whole(x), flat) for x, flat in parts]
        if rank != 0:
            return None

        def ref(x, flat):
            if flat:
                tree = self.layout.unflatten([b.cpu() for b in x])
                return tuple(self.ref_layout.flatten(stack_layers(tree,
                                                                  self.cfg)))
            return stack_layers(tree_map(lambda t: t.detach().cpu(), x),
                                self.cfg)

        p, m, v = (ref(*part) for part in parts)
        return {"params": p,
                "opt": {"m": m, "v": v, "count": opt_state["count"].cpu()}}

    def whole(self, tree):
        """Whole leaves of a tree part (gathered from this grid's slices)."""
        if self.tree_specs is None:
            return tree
        return gather_tree(tree, self.tree_specs, self.mesh)

    def slices(self, tree):
        """This rank's slices of a whole tree part (its own storage)."""
        if self.tree_specs is None:
            return tree
        return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                        shard_tree(tree, self.tree_specs, self.mesh))

    def like(self):
        """The state's structure, shapes and dtypes (meta tensors)."""
        def part(flat, dtype=None):
            if flat:
                return tuple(torch.empty(n, dtype=dtype or dt, device="meta")
                             for n, dt in zip(self.ref_layout.buffer_sizes,
                                              self.ref_layout.buffer_dtypes))
            if dtype is None:
                return self.ref_meta
            return tree_map(lambda t: torch.empty_like(t, dtype=dtype),
                            self.ref_meta)
        f32 = torch.float32
        return {"params": part(self.flat_params),
                "opt": {"m": part(self.flat_opt, f32),
                        "v": part(self.flat_opt, f32),
                        "count": torch.empty((), dtype=torch.int32,
                                             device="meta")}}

    def from_reference(self, state):
        """(params, opt_state) in the job's residency on its device: a
        flat part as this worker's shard of each bucket, a tree part as
        this rank's slices on a grid."""
        def part(x, flat):
            if flat:
                tree = unstack_layers(self.ref_layout.unflatten(list(x)),
                                      self.cfg)
                return tuple(shard_flat_buffers(
                    [b.to(self.device) for b in self.layout.flatten(tree)],
                    self.mesh))
            return self.slices(tree_map(lambda t: t.to(self.device),
                                         unstack_layers(x, self.cfg)))
        opt = state["opt"]
        return part(state["params"], self.flat_params), {
            "m": part(opt["m"], self.flat_opt),
            "v": part(opt["v"], self.flat_opt),
            "count": opt["count"].to(self.device)}


def run_training(job: TrainJob) -> dict:
    """Train as `job` says; returns the history (rank 0's, with J > 1)."""
    _check_supported(job)
    device = resolve_device(job.device)
    world = _workers(job) * job.mesh_model
    if world > 1 and num_workers() == 1:
        backend = job.dist_backend or default_backend(device)
        if "RANK" not in os.environ:
            return spawn_workers(_train, world, job, backend=backend)
        init_workers(backend, int(os.environ["RANK"]),    # under torchrun
                     int(os.environ["WORLD_SIZE"]), "env://")
    if num_workers() != world:
        raise ValueError(f"the job asks for {world} ranks, the process group "
                         f"has {num_workers()}")
    return _train(job)


def _run_id(job: TrainJob) -> str:
    """The file coordinator's namespace: a digest of the job minus the
    per-host fields, so every rank of THIS job (restarts with --resume
    included) shares one namespace, while a different job pointed at a
    reused --coord-dir never replays this run's barriers and agreements."""
    per_host = {"coord_rank", "log_path", "checkpoint_dir", "resume"}
    return "job-%08x" % zlib.crc32(repr(sorted(
        (k, v) for k, v in dataclasses.asdict(job).items()
        if k not in per_host)).encode())


def _train(job: TrainJob) -> dict:
    """The loop of one rank (all of them in lockstep)."""
    world = num_workers()
    rank = dist.get_rank() if world > 1 else 0
    mesh = (make_host_mesh(data=_workers(job), model=job.mesh_model)
            if world > 1 else None)
    workers = _workers(job)
    if job.compile_cache:
        # before any kernel loads (in this worker's process): every library
        # the job builds lands in, or comes from, the persistent cache
        enable_persistent_cache(job.compile_cache)
    device = rank_device(resolve_device(job.device), rank)
    if device.type == "cuda":
        # f32 stays f32 on the card: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches_before = launch_counts()
    cfg = get_smoke_config(job.arch) if job.smoke else get_config(job.arch)
    model = build_model(cfg)
    params = model.init(job.seed, device)
    reset_tp_stats()

    opt_cfg = AdamWConfig(lr=job.peak_lr, weight_decay=job.weight_decay,
                          grad_clip=job.grad_clip)
    if job.step_impl == "fsdp_norm":
        wrap = make_fsdp_norm_step(model, opt_cfg,
                                   variance_impl=job.variance_impl,
                                   stats_impl=job.stats_impl,
                                   params_impl=job.params_impl,
                                   params_like=params, device=device, mesh=mesh)
    else:
        wrap = make_accum_norm_step(model, opt_cfg, stats_impl=job.stats_impl,
                                    params_impl=job.params_impl,
                                    params_like=params, device=device, mesh=mesh)
    layout, grid = wrap.flat_layout, wrap.grid
    # tree leaves rest as this rank's slices on a grid
    tree_specs = (wrap.param_specs
                  if grid is not None and job.params_impl == "tree" else None)
    ckpt = _CheckpointLayout(cfg, layout, params, job.params_impl == "flat",
                             job.stats_impl == "flat", device, mesh, tree_specs)
    if tree_specs is not None:
        params = ckpt.slices(params)
    # flat moments are this worker's 1/J shard of each J-divisible bucket
    opt_state = (init_adamw_flat(params, shard_divisor=workers, layout=layout,
                                 device=device)
                 if job.stats_impl == "flat" else init_adamw(params))
    if job.params_impl == "flat":
        # flat residency (DESIGN §10): the only pack of the run — from here
        # on params are bucket buffers (the worker's shards of them) and the
        # model runs on views of the gathered buffers
        params = tuple(shard_flat_buffers(layout.flatten(params), mesh))

    def full_tree(params):
        """The whole parameter tree (gathered from every rank)."""
        if job.params_impl == "flat":
            return layout.unflatten(gather_flat_buffers(params, mesh=mesh))
        return ckpt.whole(params)

    def model_tree(params):
        """The tree this rank's model runs on: its tensor-parallel slices
        on a model axis."""
        if grid is None:
            return full_tree(params)
        if job.params_impl == "flat":
            return grid.local(full_tree(params))
        if job.step_impl == "accum_norm":       # ZeRO-3: gather the data dims
            return gather_tree(params, tree_specs, mesh, axes=data_axes(mesh))
        return params

    if job.bucket_ladder == "off":
        ladder = None
    elif job.bucket_ladder == "auto":
        top = max(job.max_global_batch, job.base_global_batch,
                  *([b for _, b in job.stages] if job.schedule == "stagewise"
                    else [0]))
        ladder = bucket_ladder(workers, job.base_micro_batch,
                               job.max_micro_batch, job.base_accum,
                               min(job.base_global_batch, top), top)
    else:
        ladder = parse_ladder(job.bucket_ladder, workers)

    # accum-free low rungs need their (M=1, J·mb) shapes on the ladder
    accum_free_below = job.accum_free_below or workers * job.max_micro_batch
    if job.accum_free and ladder is not None:
        have = {(p.accum_steps, p.micro_batch) for p in ladder}
        extra = []
        for mb in sorted({p.micro_batch for p in ladder}):
            if (1, mb) not in have:
                extra.append(BatchPlan(global_batch=workers * mb,
                                       micro_batch=mb, accum_steps=1,
                                       workers=workers))
                have.add((1, mb))
        ladder = ladder + tuple(extra)

    ctrl_cfg = ControllerConfig(
        eta=job.eta, workers=workers,
        base_micro_batch=job.base_micro_batch,
        max_micro_batch=job.max_micro_batch, base_accum=job.base_accum,
        base_global_batch=job.base_global_batch,
        max_global_batch=job.max_global_batch,
        test_interval=job.test_interval, ema=job.ema, ladder=ladder,
        predict=job.predict, gns_alpha=job.gns_alpha,
        gns_groups="accum" if job.step_impl == "accum_norm" else "workers",
        slope_alpha=job.slope_alpha, predict_horizon=job.predict_horizon)
    ctrl = init_controller(ctrl_cfg)

    if job.schedule == "constant":
        schedule = ConstantSchedule(round_plan(
            job.base_global_batch, workers, job.base_micro_batch,
            job.max_micro_batch, job.base_accum, job.base_global_batch))
    elif job.schedule == "stagewise":
        schedule = StagewiseSchedule(tuple(job.stages), workers,
                                     job.base_micro_batch, job.max_micro_batch,
                                     job.base_accum, ladder=ladder)
    else:
        schedule = None

    total_samples = job.total_samples or job.steps * job.max_global_batch
    # the paper schedules the lr in SAMPLES (Table 5: warmup 1% of training
    # samples) — the only fair basis when batch sizes differ across schemes
    warmup_samples = max(1, int(job.warmup_frac * total_samples))

    source = _make_source(job, cfg.vocab_size)
    val_source = source          # disjoint step-id stream => unseen sequences
    # stub frontends: seeded standard-normal patch embeddings or encoder
    # frames beside the tokens, as the reference's pipeline makes them
    extra_specs = {}
    if cfg.frontend.kind == "vision_stub":
        extra_specs["patch_embeds"] = (cfg.frontend.num_prefix_tokens, cfg.d_model)
    elif cfg.frontend.kind == "audio_stub":
        extra_specs["frames"] = (cfg.encoder.num_frames, cfg.d_model)
    VAL_STEP_BASE = 1_000_000_000

    coordinator = make_coordinator(job.coord, root=job.coord_dir,
                                   rank=job.coord_rank, world=job.coord_world,
                                   timeout=job.coord_timeout, run_id=_run_id(job))
    engine = (BucketedEngine(wrap, ladder, aot_warmup=job.aot_warmup,
                             coordinator=coordinator)
              if ladder is not None else None)

    def lr_at(samples_done):
        return warmup_cosine(samples_done, peak_lr=job.peak_lr,
                             min_lr=job.min_lr, warmup_steps=warmup_samples,
                             total_steps=total_samples)

    def run_step(step_fn, params, opt_state, batch_np, samples_done):
        return step_fn(params, opt_state, batch_to_device(batch_np, device),
                       lr_at(samples_done))

    def eval_loss(params):
        bplan = BatchPlan(global_batch=workers * 2, micro_batch=2,
                          accum_steps=1, workers=workers)
        tree = model_tree(params)
        losses = []
        rules = grid.rules_on() if grid is not None else contextlib.nullcontext()
        with torch.no_grad(), rules:
            for i in range(job.eval_batches):
                vb = make_batch(val_source, VAL_STEP_BASE + i, bplan,
                                job.seq_len, extra_specs)
                vb = batch_to_device({k: v[0] for k, v in vb.items()}, device)
                losses.append(float(model.loss(tree, vb)[0]))
        return float(np.mean(losses))

    history = {"step": [], "loss": [], "val_loss": [], "global_batch": [],
               "T": [], "var_l1": [], "grad_sqnorm": [], "samples": [],
               "time": [], "accum_steps": [], "opt_steps": [], "micro_steps": [],
               "pred_rung": [], "pred_eta": []}
    history["workers"] = workers
    samples = 0
    step = 0

    # ------------------------------------------------- crash-safe resume --
    # Restore the FULL loop state: params/opt (in this job's residency),
    # the controller state machine, and the step/samples cursors.
    # Everything else the loop consumes — batches, eval batches, the LR —
    # is a pure function of those cursors, so the resumed trajectory is
    # bit-identical to the uninterrupted one.
    resumed_from = None
    if job.resume:
        if not job.checkpoint_dir:
            raise ValueError("--resume requires --checkpoint-dir")
        ck = latest_step(job.checkpoint_dir)
        if ck is not None:
            state, meta = restore_checkpoint(job.checkpoint_dir, ck,
                                             ckpt.like())
            saved_job = meta.get("job", {})
            for f in ("arch", "step_impl", "stats_impl", "params_impl",
                      "schedule", "seed", "data_seed"):
                want, got = str(getattr(job, f)), str(saved_job.get(
                    f, getattr(job, f)))
                if got != want:
                    raise ValueError(
                        f"--resume config mismatch on {f!r}: checkpoint was "
                        f"saved with {got}, this job has {want}")
            params, opt_state = ckpt.from_reference(state)
            del state
            step = ck
            samples = int(meta.get("samples", 0))
            if "controller" in meta:
                ctrl = controller_state_from_dict(meta["controller"])
            resumed_from = ck
    history["resumed_from"] = resumed_from

    last_saved = [-1]

    def save_state():
        """Crash-atomic full-state checkpoint at the CURRENT step (no-op
        without a checkpoint_dir, or when this step is already on disk).
        Every worker joins the gathers; rank 0 alone writes."""
        if not job.checkpoint_dir or last_saved[0] == step:
            return
        state = ckpt.to_reference(params, opt_state, rank)
        if rank == 0:
            meta = {"job": dataclasses.asdict(job), "samples": samples,
                    "controller": controller_state_as_dict(ctrl)}
            if job.stats_impl == "flat":
                # flat moments are raw bucketed buffers: the recipe of the
                # layout they were packed at
                meta["flat_layout"] = flat_params_metadata(ckpt.ref_layout)
            if job.params_impl == "flat":
                meta[FLAT_PARAMS_META] = flat_params_metadata(ckpt.ref_layout)
            save_checkpoint(job.checkpoint_dir, step, state, metadata=meta)
        del state
        if world > 1:
            dist.barrier()         # no rank runs ahead of the commit
        last_saved[0] = step

    t0 = time.time()
    log_f = (open(job.log_path, "a" if resumed_from is not None else "w")
             if job.log_path and rank == 0 else None)
    if log_f and resumed_from is None:
        log_f.write("step,samples,global_batch,accum,micro,loss,val_loss,T,var_l1,grad_sqnorm,wall_s\n")

    def seq_len_for(samples_done: int) -> int:
        if not job.seq_stages:
            return job.seq_len
        frac = samples_done / max(total_samples, 1)
        acc = 0.0
        for f, sl in job.seq_stages:
            acc += f
            if frac < acc:
                return sl
        return job.seq_stages[-1][1]

    try:
        while samples < total_samples and step < job.steps:
            # injection site: the Nth call is the Nth step of the RUN, not
            # of this process — kill rules key on it
            fault_point("train.step", step=step + 1)
            plan = (schedule.plan_for(samples, total_samples)
                    if schedule is not None else ctrl.plan)
            batch_np = make_batch(source, step, plan, seq_len_for(samples),
                                  extra_specs)
            bucket = engine.bucket_for(plan.global_batch) if engine else None

            # accum-free low rungs (DESIGN §14): the same guards as the
            # reference — the plan must BE its rung, and a tested adaptive
            # step must keep a live variance signal (ACCUM-NORM's M=1
            # variance is identically zero)
            tested = (job.schedule == "adaptive" and not ctrl.at_max
                      and (ctrl_cfg.test_interval <= 1
                           or (ctrl.step + 1) % ctrl_cfg.test_interval == 0))
            signal_alive = job.step_impl == "fsdp_norm" and workers > 1
            use_af = (job.accum_free and plan.accum_steps > 1
                      and plan.global_batch <= accum_free_below
                      and (bucket is None or bucket == plan)
                      and (job.schedule != "adaptive" or not tested
                           or signal_alive))

            if use_af:
                sub_plan, repeats = accum_free_plan(plan)
                sub_losses = []
                for m in range(repeats):
                    sub_np = {k: v[m:m + 1] for k, v in batch_np.items()}
                    if engine is not None:
                        # (1, J·mb) is on the ladder by construction
                        step_fn = engine.get_step(sub_np)
                        engine.observe(sub_plan, sub_plan)
                    else:
                        step_fn = wrap(sub_np)
                    params, opt_state, metrics = run_step(
                        step_fn, params, opt_state, sub_np, samples)
                    samples += sub_plan.global_batch
                    sub_losses.append(float(metrics["loss"]))
                loss = float(np.mean(sub_losses))
                # rescale the sub-batch var_l1 to the scheduled plan's batch
                var_l1 = (float(metrics["var_l1"])
                          * sub_plan.global_batch / plan.global_batch)
                gsq = float(metrics["grad_sqnorm"])
                exec_plan, opt_steps = sub_plan, repeats
                micro_steps = repeats
            else:
                if engine is not None:
                    batch_np = pad_to_bucket(batch_np, plan, bucket)
                    step_fn = engine.get_step(batch_np)
                    engine.observe(plan, bucket)
                else:
                    step_fn = wrap(batch_np)
                params, opt_state, metrics = run_step(
                    step_fn, params, opt_state, batch_np, samples)
                var_l1 = float(metrics["var_l1"])
                gsq = float(metrics["grad_sqnorm"])
                loss = float(metrics["loss"])
                samples += plan.global_batch
                exec_plan, opt_steps = plan, 1
                # the microbatches the step ran: its bucket's M when padded
                micro_steps = len(batch_np["tokens"])
            step += 1
            if job.schedule == "adaptive":
                ctrl = controller_update(ctrl_cfg, ctrl, var_l1, gsq)
            if engine is not None:
                # warm-up AFTER the controller decision (DESIGN §14): the
                # rung the controller just grew to, else the predicted
                # target rung, else the next rung up — a function of
                # globally reduced statistics, so every host proposes the
                # same rung
                proposal = None
                if job.schedule == "adaptive":
                    if ctrl.plan.global_batch > bucket.global_batch:
                        proposal = engine.bucket_for(ctrl.plan.global_batch)
                    elif job.predict and ctrl.pred_rung > bucket.global_batch:
                        proposal = engine.bucket_for(ctrl.pred_rung)
                engine.warmup_agreed(bucket, batch_np, proposal=proposal)

            val = math.nan
            if job.eval_every and (step % job.eval_every == 0
                                   or step == job.steps):
                val = eval_loss(params)

            t_stat = var_l1 / (job.eta**2 * gsq + 1e-30)
            history["step"].append(step)
            history["loss"].append(loss)
            history["val_loss"].append(val)
            history["global_batch"].append(plan.global_batch)
            history["T"].append(t_stat)
            history["var_l1"].append(var_l1)
            history["grad_sqnorm"].append(gsq)
            history["samples"].append(samples)
            history["time"].append(time.time() - t0)
            history["accum_steps"].append(exec_plan.accum_steps)
            history["opt_steps"].append(opt_steps)
            history["micro_steps"].append(micro_steps)
            history["pred_rung"].append(
                ctrl.pred_rung if job.schedule == "adaptive" else 0)
            history["pred_eta"].append(
                ctrl.pred_eta_steps if job.schedule == "adaptive" else -1.0)
            if log_f:
                log_f.write(
                    f"{step},{samples},{plan.global_batch},"
                    f"{exec_plan.accum_steps},{exec_plan.micro_batch},"
                    f"{loss:.4f},"
                    f"{val:.4f},{t_stat:.1f},{var_l1:.4g},{gsq:.4g},"
                    f"{time.time()-t0:.1f}\n")
                log_f.flush()
            # save AFTER the step's metrics land (log line k precedes
            # checkpoint k: a resumed log never skips a line)
            if job.checkpoint_every and step % job.checkpoint_every == 0:
                save_state()
        save_state()
    except CoordinationError as e:
        # a peer is dead or never arrived: the fleet cannot go on, but this
        # rank's state is intact — checkpoint it and exit (DESIGN §12), so
        # a restarted fleet resumes from here
        save_state()
        history["coordination_failure"] = str(e)
        if engine is not None:
            engine.drain(raise_errors=False)
        if coordinator is not None:
            coordinator.close()
        raise
    finally:
        if log_f:
            log_f.close()

    if engine is not None:
        # a failed warm-up already fell back to a foreground build; it
        # shows as stats.warmup_failures rather than ending the run
        engine.drain(raise_errors=False)
        history["engine"] = engine.stats.as_dict()
    if coordinator is not None:
        coordinator.close()
    history["final_params"] = full_tree(params)
    # what each rank ran: its kernel launches in this run, its peak device
    # memory (a spawned rank's counters are not the caller's), and on a
    # model axis its tensor-parallel collectives and their host seconds
    # (None under NCCL, whose calls return once enqueued)
    mine = {"launches": {k: n - launches_before[k]
                         for k, n in launch_counts().items()},
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None)}
    if job.mesh_model > 1:
        blocks = torch.distributed.get_backend() == "gloo"
        mine.update(tp_allreduce_s=TP_STATS["seconds"] if blocks else None,
                    tp_allreduce_calls=TP_STATS["calls"])
    history["ranks"] = [mine]
    if world > 1:
        history["ranks"] = [None] * world
        torch.distributed.all_gather_object(history["ranks"], mine)
    return history


def summarize(history: dict) -> dict:
    losses = [l for l in history["loss"] if math.isfinite(l)]
    vals = [v for v in history["val_loss"] if math.isfinite(v)]
    out = {
        "steps": history["step"][-1] if history["step"] else 0,
        "avg_batch": float(np.mean(history["global_batch"])) if history["global_batch"] else 0,
        "best_loss": min(losses) if losses else math.nan,
        "best_val_loss": min(vals) if vals else math.nan,
        "wall_s": history["time"][-1] if history["time"] else 0.0,
    }
    eng = history.get("engine")
    if eng:
        out["engine"] = {k: eng[k] for k in
                         ("compiles", "hit_rate", "padding_waste", "warmups",
                          "barrier_wait_s", "desyncs", "disk_cache_hits",
                          "transitions", "transition_hits")}
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainJob):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, action="store_true", default=f.default)
        elif f.name in ("stages", "seq_stages"):
            p.add_argument(name, type=str, default=None,
                           help="e.g. '0.025:16,0.025:64,0.95:256'")
        else:
            typ = type(f.default) if f.default is not None else int
            p.add_argument(name, type=typ, default=f.default)
    # --smoke is on by default; --full-size turns it off
    p.add_argument("--full-size", dest="smoke", action="store_false")
    args = p.parse_args(argv)
    kw = vars(args)
    for name in ("stages", "seq_stages"):
        if isinstance(kw.get(name), str) and kw[name]:
            kw[name] = tuple((float(a), int(b)) for a, b in
                             (s.split(":") for s in kw[name].split(",")))
        else:
            kw[name] = getattr(TrainJob, name)
    hist = run_training(TrainJob(**kw))
    print(json.dumps(summarize(hist), indent=2))


if __name__ == "__main__":
    main()
