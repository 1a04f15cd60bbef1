"""One rank of a cell's run: the port's training step driven as
`launch/train.py::_train` drives it, step after step.

Set-up builds one object — the step from `make_accum_norm_step` or
`make_fsdp_norm_step` (flat params, flat statistics) behind a
`BucketedEngine`, its optimizer state, the controller — on weights made
from the seed, and drives it through the cell's first steps (the check
steps, which are also the warm-up of the one shape the cell uses).  The
same object then runs the measured window.  Each step: the batch made from
the seed, `engine.get_step`, the step, its metrics read on the host, then
`controller_update`.  The benchmark owns only the clock and the data.

What the check compares is read on the way: each check step's loss,
statistic and decision; the first gradient as the optimizer got it (its
first moment after step 1 over 1 − β1); after the last check step the
change of each parameter leaf and both moments.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch
import torch.distributed as dist

from benchkit import spans as spans_lib
from benchkit.traffic import MarkovTokens, learning_rate, make_batch
from benchkit.weights import leaf_items, make_weights


@dataclasses.dataclass
class Spec:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_process: float              # time.time() when the process started
    device: str = ""              # "" = the CUDA card of the rank
    smoke: bool = False           # the configuration's and traffic's smoke sizes
    fault: str = ""               # a planted fault (tests, calibration)


def model_dict(config: dict, smoke: bool) -> dict:
    m = dict(config["model"])
    if smoke:
        m.update(config.get("smoke", {}))
    return m


def traffic_dict(traffic: dict, smoke: bool) -> dict:
    t = dict(traffic)
    if smoke:
        t.update(traffic.get("smoke", {}))
    return t


def port_config(m: dict):
    """The port's `ModelConfig` of a configuration's `model` entry."""
    from repro_torch.models import config as mc
    nested = {"ssm": mc.SSMConfig, "moe": mc.MoEConfig, "mla": mc.MLAConfig,
              "rglru": mc.RGLRUConfig, "encoder": mc.EncoderConfig,
              "frontend": mc.FrontendConfig}
    kw = {}
    for k, v in m.items():
        if k in nested and isinstance(v, dict):
            v = nested[k](**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return mc.ModelConfig(**kw)


class _Rank:
    def __init__(self, spec: Spec, rank: int, world: int):
        from repro_torch.core.controller import ControllerConfig, init_controller
        from repro_torch.core.schedule import bucket_ladder
        from repro_torch.distributed.engine import BucketedEngine
        from repro_torch.distributed.sharding import shard_flat_buffers
        from repro_torch.distributed.train_step import (
            make_accum_norm_step, make_fsdp_norm_step)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.model import build_model
        from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat

        self.spec, self.rank, self.world = spec, rank, world
        if spec.fault == "no_exchange":
            _leave_out_exchange()
        tr = self.tr = traffic_dict(spec.traffic, spec.smoke)
        if (tr["stats_impl"], tr["params_impl"]) != ("flat", "flat"):
            raise ValueError("the benchmark drives flat params and flat statistics")
        device = (torch.device(spec.device) if spec.device else
                  torch.device("cuda", rank % torch.cuda.device_count()))
        if device.type == "cuda":
            # as `_train` sets the card: f32 stays f32, the rank's card, the
            # peak counted from here
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.device = device
        self.mesh = make_host_mesh(data=world) if world > 1 else None
        self.mdict = model_dict(spec.config, spec.smoke)
        model = build_model(port_config(self.mdict))
        self.like = family_shapes(spec.config, self.mdict)
        if _shapes(self.like) != _shapes(model.init(0, "meta")):
            raise ValueError(f"{spec.config['name']}: the reference's parameter "
                             f"tree differs from the program's")
        self.init = spec.config["init"]
        weights = make_weights(self.like, spec.seed, device, self.init)
        # the weights as made, for each leaf's change over the check steps
        # (on the host: a whole model's copy would not fit beside its state)
        self.p0 = ({p: x.to("cpu") for p, x in leaf_items(weights)}
                   if rank == 0 else None)
        opt = tr["optimizer"]
        self.opt = opt
        opt_cfg = AdamWConfig(lr=opt["peak_lr"], beta1=opt["beta1"], beta2=opt["beta2"],
                              eps=opt["eps"], weight_decay=opt["weight_decay"],
                              grad_clip=opt["grad_clip"])
        make = make_accum_norm_step if tr["step"] == "accum_norm" else make_fsdp_norm_step
        wrap = make(model, opt_cfg, stats_impl="flat", params_impl="flat",
                    params_like=weights, device=device, mesh=self.mesh)
        self.layout = wrap.flat_layout
        J = tr["workers"]
        if J != world:
            raise ValueError(f"traffic {tr['name']} has {J} workers, the run {world} ranks")
        self.opt_state = init_adamw_flat(weights, shard_divisor=J, layout=self.layout,
                                         device=device)
        self.params = tuple(shard_flat_buffers(self.layout.flatten(weights), self.mesh))
        del weights
        gb, mb, acc = tr["global_batch"], tr["micro_batch"], tr["accum"]
        ladder = bucket_ladder(J, mb, mb, acc, gb, gb)
        self.ctrl_cfg = ControllerConfig(
            eta=tr["eta"], workers=J, base_micro_batch=mb, max_micro_batch=mb,
            base_accum=acc, base_global_batch=gb, max_global_batch=gb, ladder=ladder,
            gns_groups="accum" if tr["step"] == "accum_norm" else "workers")
        self.ctrl = init_controller(self.ctrl_cfg)
        self.engine = BucketedEngine(wrap, ladder)
        self.plan = self.ctrl.plan
        self.bucket = self.engine.bucket_for(self.plan.global_batch)
        self.source = MarkovTokens(self.mdict["vocab_size"], spec.seed, tr["fan_out"])
        self.k = 0
        self.samples = tr["lr_schedule"]["samples_start"]

    # ------------------------------------------------------------ step --

    def batch(self, k: int) -> dict:
        tr = self.tr
        return make_batch(self.source, k, tr["accum"], tr["workers"] * tr["micro_batch"],
                          tr["seq_len"])

    def lr(self, samples: int) -> float:
        return learning_rate(samples, self.opt, self.tr["lr_schedule"])

    def step(self) -> dict:
        from repro_torch.core.controller import controller_update
        from repro_torch.distributed.train_step import batch_to_device
        ns = time.time_ns
        t0, n0 = time.perf_counter(), ns()
        batch = self.batch(self.k)
        t1, n1 = time.perf_counter(), ns()
        fn = self.engine.get_step(batch)
        self.engine.observe(self.plan, self.bucket)
        t2, n2 = time.perf_counter(), ns()
        dev = batch_to_device(batch, self.device)
        params, opt_state = self.params, self.opt_state
        if self.spec.fault == "half_batch":
            # half of every microbatch's rows left out, the mean over the rest
            dev = {n: x[:, : x.shape[1] // 2] for n, x in dev.items()}
        if self.spec.fault == "unchanged":
            params = tuple(b.clone() for b in params)
            opt_state = {"m": tuple(b.clone() for b in opt_state["m"]),
                         "v": tuple(b.clone() for b in opt_state["v"]),
                         "count": opt_state["count"].clone()}
        params, opt_state, metrics = fn(params, opt_state, dev, self.lr(self.samples))
        if self.spec.fault != "unchanged":
            self.params, self.opt_state = params, opt_state
        loss, var_l1, gsq = (float(metrics[n]) for n in ("loss", "var_l1", "grad_sqnorm"))
        t3, n3 = time.perf_counter(), ns()
        before = self.ctrl
        self.ctrl = controller_update(self.ctrl_cfg, self.ctrl, var_l1, gsq)
        t4, n4 = time.perf_counter(), ns()
        b = self.plan.global_batch
        decision = ("untested" if before.at_max else
                    "grow" if self.ctrl.last_T > b else "stay")
        self.k += 1
        self.samples += b
        return {"t0": t0, "t1": t4, "host_s": (t1 - t0) + (t2 - t1) + (t4 - t3),
                "ns": (n0, n4), "spans": [("bench.make_batch", n0, n1),
                                          ("bench.get_step", n1, n2),
                                          ("bench.controller", n3, n4)],
                "tokens": b * self.tr["seq_len"], "loss": loss, "var_l1": var_l1,
                "grad_sqnorm": gsq, "T": self.ctrl.last_T, "decision": decision}

    # ----------------------------------------------------------- check --

    def _full(self, buffers):
        """The whole leaves of flat state (gathered from every worker's
        shard: every rank takes part)."""
        from repro_torch.distributed.sharding import gather_flat_buffers
        return self.layout.unflatten(gather_flat_buffers(list(buffers), mesh=self.mesh))

    def _norms(self, buffers, scale: float = 1.0, minus=None) -> dict:
        tree = self._full(buffers)
        if self.rank != 0:
            return {}
        with torch.no_grad():
            return {p: float(torch.linalg.vector_norm(
                        (x - minus[p].to(x.device) if minus else x).double())) * scale
                    for p, x in leaf_items(tree)}

    def check_steps(self) -> dict:
        """Drive the object through the check steps; their numbers (on
        rank 0)."""
        keys = ("loss", "var_l1", "grad_sqnorm", "T", "decision")
        out = {n: [] for n in keys}
        for i in range(self.tr["check_steps"]):
            s = self.step()
            for n in keys:
                out[n].append(s[n])
            if i == 0:
                out["grad_leaf"] = self._norms(self.opt_state["m"],
                                               1.0 / (1.0 - self.opt["beta1"]))
        out["update_leaf"] = self._norms(self.params, minus=self.p0)
        out["m_leaf"] = self._norms(self.opt_state["m"])
        out["v_leaf"] = self._norms(self.opt_state["v"])
        self.p0 = None
        return out

    # ---------------------------------------------------------- window --

    def _go_on(self, t_start: float) -> bool:
        go = time.perf_counter() - t_start < self.spec.seconds
        if self.world == 1:
            return go
        flag = torch.tensor([1 if go else 0], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, 0)            # rank 0's clock decides for all
        return bool(flag.item())

    def window(self):
        """The measured window; with a trace, its first `trace_steps` steps
        under the profiler (the card's activity alone: host-side tracing
        of every operation would slow the host several-fold where kernels
        are small) and with the program's spans recorded
        (`repro_torch.tracing`, on only while the profiler is)."""
        from repro_torch import tracing
        steps, prof, n_traced = [], None, self.tr["trace_steps"]
        t_untraced = None          # where the window's untraced part starts
        if self.spec.trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA]
                           if self.device.type == "cuda" else [ProfilerActivity.CPU])
        t_start = time.perf_counter()
        while self._go_on(t_start):
            traced = prof is not None and len(steps) < n_traced
            if traced and not steps:
                prof.start()
                tracing.enable()
            s = self.step()
            s["traced"] = traced
            steps.append(s)
            if traced and len(steps) == n_traced:
                tracing.disable()
                prof.stop()
                t_untraced = time.perf_counter()
        if prof is not None and steps and len(steps) < n_traced:
            tracing.disable()
            prof.stop()
        trace = None
        done = [s for s in steps if s["traced"]]
        if done:
            trace = spans_lib.reduce_events(
                prof.profiler.kineto_results.events(),
                (done[0]["ns"][0], done[-1]["ns"][1]), len(done),
                [sp for s in done for sp in s["spans"]],
                program_spans=tracing.collect())
        return steps, trace, t_start, t_untraced

    def free(self):
        """Drop the program's state (the reference runs after it)."""
        for name in ("params", "opt_state", "engine", "layout", "ctrl"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _leave_out_exchange():
    """Plant the fault "the exchange between chips left out": each worker's
    mean gradient is its own."""
    from repro_torch.distributed import train_step

    def local_mean(local, w_j, out, group=None):
        for o, x in zip(out, local):
            o.copy_(x)
        return torch.clamp(w_j.clone(), min=1.0)

    train_step.worker_mean = local_mean


def run_rank(spec: Spec, rank: int = 0, world: int = 1) -> dict:
    """Set-up, check steps, window, trace reduction: this rank's record
    (host numbers only)."""
    r = _Rank(spec, rank, world)
    check = r.check_steps()
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
        torch.cuda.reset_peak_memory_stats(r.device)
    setup_s = time.time() - spec.t_process
    steps, traced, t_start, t_untraced = r.window()
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else None)
    flat_elements = sum(b.numel() for b in r.params)
    full_elements = sum(r.layout.buffer_sizes)
    r.free()
    if spec.fault == "jax_in_rank" and rank == world - 1 > 0:
        # planted for the tests: a spawned rank that loaded JAX
        import types
        sys.modules["jax"] = types.ModuleType("jax")
    # what a spawned rank's process loaded by the window's close: the run is
    # refused if JAX or the JAX package is among it (`cli.run`).  A lone
    # rank is the process that prints the result, which `cli.main` checks.
    from benchkit.cli import loaded_forbidden
    forbidden = loaded_forbidden() if world > 1 else []
    return {"rank": rank, "setup_s": setup_s, "t_start": t_start,
            "t_untraced": t_untraced, "steps": steps, "peak_mem_bytes": peak,
            "trace": traced, "check": check, "flat_elements": flat_elements,
            "full_elements": full_elements, "forbidden": forbidden}


def _shapes(tree) -> dict:
    return {p: tuple(x.shape) for p, x in leaf_items(tree)}


def family_shapes(config: dict, m: dict, reference=None):
    """The parameter tree the configuration's reference module (`reference`,
    else the one its name finds) describes, as meta tensors: the layout in
    which the benchmark hands both sides its weights."""
    if reference is None:
        from benchkit.manifest import reference_module
        reference = reference_module(config["reference"])
    return _meta(reference.param_shapes(m))


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree, dtype=torch.float32, device="meta")


def run_ranks(spec: Spec) -> list[dict] | None:
    """`run_rank` on this rank of the process group; rank 0 gets every
    rank's record."""
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = run_rank(spec, rank, world)
    recs = [None] * world
    dist.all_gather_object(recs, rec)
    return recs if rank == 0 else None
