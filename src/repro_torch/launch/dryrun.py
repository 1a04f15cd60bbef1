"""The dry-run: one rank's step at full size on the production meshes,
traced with no allocation, and what it costs (counterpart of
`repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--jobs 8] [--seqpar]

`lower_combo` joins a fake process group of 256 (16 × 16) or 512
(2 × 16 × 16) ranks as rank 0 (`launch/mesh.py::init_fake_workers`),
builds the mesh, the model and the step as a real rank does — the
FSDP-Norm or ACCUM-NORM step with the flat residencies (`--seqpar`: the
FSDP-Norm step with sequence parallelism, as in the reference; the other
steps and shapes ignore it, and the record's `seqpar` says whether it
applied), the prefill, or the decode step — makes the rank's parameters,
optimizer state and
inputs under `FakeTensorMode`, and runs the step once.  Fake tensors
carry shapes, dtypes and devices and no storage, so nothing is
allocated; the fake group's collectives move nothing.  The kernels are
custom ops whose fake implementations make only their outputs.  The
trace records:

* memory: a live-storage tally of every tensor the trace creates — the
  rank's parameters, optimizer state and inputs, the buffers the step
  keeps (its flat gradient and gather buffers), the activation and
  temporary peak above them, `peak_bytes`, and `fits` (peak ≤ the card's
  memory);
* cost: FLOPs from `torch.utils.flop_counter.FlopCounterMode` (with
  `flash_attention`'s formula: 4·d a (query, key) pair its masks admit;
  `dense`'s 2·M·N·K), split by the class each product runs at
  (`roofline.PEAKS`: the two kernels' f32 products at `split_tf32`); bytes
  accessed, the input and output bytes of every dispatched op that moves
  data (no view, allocation or metadata read), an in-place operand read
  and written once each, a gather's source counted as the rows it reads;
* the collective tally (`roofline.note_collective`) and the kernel entry
  points' calls (`kernels.ops.call_counts`; on the card, its launches);
* the three roofline terms on an H100 (`roofline.roofline_terms`).

There is no depth calibration: the reference compiles depth-1 and
depth-2 variants because XLA's cost analysis counts a loop body once;
an eager trace runs every layer, so its counts are the whole step's.
There is no compile time either: `--bucket-ladder` traces each
accumulation rung and records whether it fits, its peak and its FLOPs.

The trace runs on "cuda" (fake CUDA tensors: the kernels' path, the
bytes and FLOPs of the card) unless asked for `--device cpu`, which
takes the kernels' plain versions instead — flash's full attention
matrix among its temporaries and its einsums among the FLOPs — so the
CPU shows the layout, the parameters and the collectives, not the card's
kernels.  A torch with no CUDA build raises rather than tracing on the
CPU; its backward on fake CUDA tensors would abort the process.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
from repro_torch.distributed.params import _dims, _is_spec, cache_pspecs, shard_tree
from repro_torch.distributed.serve_step import (
    data_rows, make_decode_step, make_prefill)
from repro_torch.distributed.train_step import (
    make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (
    init_fake_workers, make_production_mesh, num_workers)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat
from repro_torch.tree import tree_flatten, tree_map

# ops that move no data: allocations and metadata (views are found from
# their schemas)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided", "aten::detach",
               "aten::lift_fresh", "aten::_unsafe_view", "aten::alias"}
# the kernels whose f32 products run as three TF32 products on the tensor
# cores (`roofline.PEAKS["split_tf32"]`)
_SPLIT_TF32 = {"repro_torch::flash_attention", "repro_torch::dense"}
# ops that read only the rows they return from their source (the first
# argument; `embedding`'s table): the source counts as the result's bytes
_GATHERS = {"aten::embedding", "aten::index_select", "aten::gather",
            "aten::index"}


def _tensors(x):
    """The tensors of an op's arguments or results: a tensor, or a list or
    tuple holding tensors and lists of tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for a in x if isinstance(x, (list, tuple)) else ():
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.cache
def _traffic(func):
    """How an op moves data, from its schema: None for one that moves
    none (a view, an allocation, a metadata read such as `prim.device`),
    else (the indices of the arguments it writes in place, for each result
    whether it is fresh or an alias, whether it is a gather)."""
    schema = func._schema
    rets = schema.returns
    written = tuple(i for i, a in enumerate(schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
    if (func.namespace == "prim" or schema.name in _NO_TRAFFIC
            or (rets and all(r.alias_info is not None and not r.alias_info.is_write
                             for r in rets))):
        return None
    return written, tuple(r.alias_info is None for r in rets), schema.name in _GATHERS


def compute_class(func, args) -> str:
    """The rate class of a counted product: its first operand's dtype, and
    `split_tf32` for the f32 products of the flash and dense kernels."""
    name = str(_tensors(args)[0].dtype).removeprefix("torch.")
    if func._schema.name in _SPLIT_TF32 and name == "float32":
        return "split_tf32"
    return name


class TraceTally(TorchDispatchMode):
    """What one traced run dispatches: the live bytes of every storage an
    op creates (and their peak), bytes accessed, FLOPs by rate class, and
    the collectives.  Enter it inside `FakeTensorMode` (and inside a
    `FlopCounterMode`, whose total `Trace` checks against this split)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.flops = {}
        self.collectives = roofline.empty_collectives()
        self._seen = weakref.WeakKeyDictionary()

    def track(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in roofline.COLLECTIVE_NAMESPACES:
            roofline.note_collective(self.collectives, func, args)
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten":
            # a composite op that reaches the mode undecomposed (grad mode
            # off) runs as its parts, as `FlopCounterMode` runs it, so that
            # its products are counted here too
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            cls = compute_class(func, args)
            self.flops[cls] = self.flops.get(cls, 0) + flop_registry[packet](
                *args, **kwargs, out_val=out)
        traffic = _traffic(func)
        results = _tensors(out)
        if traffic is not None and (results or traffic[0]):
            written, fresh, gather = traffic
            read = _tensors(args[1:]) if gather else _tensors(args)
            moved = sum(_nbytes(t) for t in read)
            moved += sum(_nbytes(t) for t in _tensors(list(kwargs.values())))
            moved += sum(_nbytes(t) for i in written if i < len(args)
                         for t in _tensors(args[i]))
            out_bytes = sum(_nbytes(t) for t in results)
            if len(results) == len(fresh):
                out_bytes = sum(_nbytes(t) for t, f in zip(results, fresh) if f)
            # a gather reads from its source what it writes
            self.bytes_accessed += moved + out_bytes * (2 if gather else 1)
        self.track(_tensors(out))
        return out


class Trace:
    """Trace one run: `with FakeTensorMode(), Trace() as tr:` make the
    step's state (`tr.mark(name)` after each part records its bytes), run
    the step, drop its outputs and call `tr.finish()`.  Then `tr.memory`,
    `tr.cost`, `tr.collectives`, `tr.kernel_calls` and `tr.seconds`.
    `tally`: the `TraceTally` to run under (a subclass that records more,
    `analysis/graph_check.py`); a fresh one by default."""

    def __init__(self, tally: TraceTally | None = None):
        self._tally = tally

    def __enter__(self):
        self.marks = {}
        self._t0 = time.perf_counter()
        self._calls = ops.call_counts()
        self.flop_counter = FlopCounterMode(display=False)
        self.flop_counter.__enter__()
        self.tally = self._tally if self._tally is not None else TraceTally()
        self.tally.__enter__()
        return self

    def mark(self, name: str):
        """The live bytes not yet marked, under `name`."""
        self.marks[name] = self.tally.live - sum(self.marks.values())

    def finish(self):
        """After the step's outputs are dropped: what the step kept."""
        gc.collect()
        self.marks["buffers"] = self.tally.live - sum(self.marks.values())

    def __exit__(self, *exc):
        self.tally.__exit__(*exc)
        self.flop_counter.__exit__(*exc)
        self.seconds = time.perf_counter() - self._t0
        self.kernel_calls = {k: n - self._calls[k]
                             for k, n in ops.call_counts().items()}
        if exc[0] is not None:
            return False
        total = self.flop_counter.get_total_flops()
        split = sum(self.tally.flops.values())
        if total != split:
            raise RuntimeError(f"FlopCounterMode counted {total} FLOPs, the "
                               f"tally's classes {split}")
        self.cost = {"flops": float(total),
                     "bytes accessed": float(self.tally.bytes_accessed),
                     "flops_by_class": {k: float(v) for k, v in
                                        sorted(self.tally.flops.items())}}
        self.collectives = self.tally.collectives
        peak = self.tally.peak
        resident = sum(self.marks.values())
        self.memory = {**{f"{k}_bytes": v for k, v in self.marks.items()},
                       "activation_peak_bytes": peak - resident,
                       "peak_bytes": peak,
                       "card_bytes": roofline.CARD_BYTES,
                       "fits": peak <= roofline.CARD_BYTES}
        return False


# ------------------------------------------------------------ the state ----

def _fake(like, device):
    """Tensors of `like`'s shapes and dtypes (fake under `FakeTensorMode`),
    each its own contiguous storage: a meta leaf's on `device`, any other
    leaf's on its own device."""
    return tree_map(lambda x: torch.empty(
        tuple(x.shape), dtype=x.dtype,
        device=device if x.device.type == "meta" else x.device), like)


def _whole(like):
    """Specs that leave every leaf whole (one rank)."""
    return tree_map(lambda x: (None,) * x.dim(), like)


def spec_bytes(like, specs, mesh) -> int:
    """Bytes of this rank's slices of the whole leaves `like`, from the
    specs alone: each sharded dim divided by its axes' sizes (the check on
    the tally's parameter bytes)."""
    leaves = tree_flatten(like)[0]
    spec_leaves = tree_flatten(specs, is_leaf=_is_spec)[0]
    total = 0
    for x, spec in zip(leaves, spec_leaves, strict=True):
        n = math.prod(x.shape)
        for _, axes in _dims(spec, None):
            n //= math.prod(mesh.shape[a] for a in axes)
        total += n * x.element_size()
    return total


def trace_train(cfg, batch_like, mesh, device, *, step_impl="fsdp_norm",
                variance_impl="scalar", seqpar=False):
    """Trace one training step of this rank, flat stats and params, on
    the GLOBAL batch `batch_like` (meta tensors, (M, B, ...) leaves);
    returns (trace, the bytes of its parameter shards from the specs).
    `mesh` None: one rank.  `seqpar`: FSDP-Norm with sequence
    parallelism."""
    model = build_model(cfg)
    like = model.init(device="meta")
    opt_cfg = AdamWConfig()
    if step_impl == "fsdp_norm":
        wrap = make_fsdp_norm_step(model, opt_cfg, variance_impl=variance_impl,
                                   stats_impl="flat", params_impl="flat",
                                   sequence_parallel=seqpar, params_like=like,
                                   device=device, mesh=mesh)
    elif step_impl == "accum_norm":
        wrap = make_accum_norm_step(model, opt_cfg, stats_impl="flat",
                                    params_impl="flat", params_like=like,
                                    device=device, mesh=mesh)
    else:
        raise ValueError(f"step_impl must be 'fsdp_norm' or 'accum_norm', got "
                         f"{step_impl!r}")
    step = wrap(None)
    layout = wrap.flat_layout
    # the rank's parameters rest as the step's specs give them: its shard
    # of each bucket
    whole = [torch.empty(n, dtype=dt, device="meta")
             for n, dt in zip(layout.buffer_sizes, layout.buffer_dtypes)]
    specs = (list(wrap.param_specs) if wrap.param_specs is not None
             else [() for _ in whole])
    rank_like = shard_tree(whole, specs, mesh)
    with FakeTensorMode(), Trace() as tr:
        params = tuple(_fake(rank_like, device))
        tr.mark("params")
        opt = init_adamw_flat(like, layout=layout, device=device)
        tr.mark("opt_state")
        batch = _fake(batch_like, device)
        tr.mark("inputs")
        out = step(params, opt, batch, 1e-4)
        del out
        tr.finish()
    return tr, spec_bytes(whole, specs, mesh)


def trace_prefill(cfg, batch_like, mesh, device):
    """Trace one prefill of this rank's rows of the global batch
    `batch_like` ({"tokens": (b, t)} and a front end's inputs); `mesh`
    None: one rank."""
    model = build_model(cfg)
    like = model.init(device="meta")
    b = batch_like["tokens"].shape[0]
    if mesh is None:
        run, p_specs, rows = make_prefill(model), _whole(like), slice(None)
    else:
        wrap, p_specs = make_prefill(model, mesh, batch=b)
        run, rows = wrap(None), data_rows(b, mesh)
    rank_like = shard_tree(like, p_specs, mesh)
    rows_like = {k: v[rows] for k, v in batch_like.items()}
    with FakeTensorMode(), Trace() as tr:
        params = _fake(rank_like, device)
        tr.mark("params")
        batch = _fake(rows_like, device)
        tr.mark("inputs")
        out = run(params, batch)
        del out
        tr.finish()
    return tr, spec_bytes(like, p_specs, mesh)


def trace_decode(cfg, specs, mesh, device, pos: int):
    """Trace one decode step of this rank over `decode_inputs`' `specs` at
    position `pos` (the port's decode takes a scalar position as a host
    int: a tensor would be read back to the host every step); `mesh`
    None: one rank."""
    model = build_model(cfg)
    like = model.init(device="meta")
    b = specs["tokens"].shape[0]
    if mesh is None:
        step = make_decode_step(model, ring=specs["ring"])
        p_specs, c_specs, rows = _whole(like), _whole(specs["cache"]), slice(None)
    else:
        wrap, p_specs = make_decode_step(model, mesh, batch=b, ring=specs["ring"])
        step, rows = wrap(specs["cache"]), data_rows(b, mesh)
        c_specs = cache_pspecs(specs["cache"], mesh,
                               batch_divisible=b % num_workers(mesh) == 0)
    rank_like = shard_tree(like, p_specs, mesh)
    cache_like = shard_tree(specs["cache"], c_specs, mesh)
    tokens_like = specs["tokens"][rows]
    with FakeTensorMode(), Trace() as tr:
        params = _fake(rank_like, device)
        tr.mark("params")
        cache = _fake(cache_like, device)
        tr.mark("cache")
        tokens = _fake(tokens_like, device)
        tr.mark("inputs")
        out = step(params, cache, tokens, pos)
        del out
        tr.finish()
    return tr, spec_bytes(like, p_specs, mesh)


# ------------------------------------------------------------- records ----

def dryrun_config(arch: str, remat: str = "full"):
    """Full config tuned for the trace: bf16, remat, chunked xent."""
    cfg = get_config(arch)
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16",
                       remat=remat, xent_chunk=512)


def resolve_trace_device(device: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("the dry-run traces the card's step on fake CUDA "
                           "tensors, and this torch has no CUDA build; pass "
                           "--device cpu to trace the CPU's step instead")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the dry-run traces on 'cuda' or 'cpu', got {device}")
    return device


def trace_combo(cfg, shape, mesh, device, *, step_impl="fsdp_norm", accum=1,
                variance_impl="scalar", seqpar=False):
    """Trace one (config, input shape) on `mesh`: (trace, parameter bytes
    from the specs)."""
    specs = input_specs(cfg, shape.name, accum=accum)
    if shape.kind == "train":
        return trace_train(cfg, specs, mesh, device, step_impl=step_impl,
                           variance_impl=variance_impl, seqpar=seqpar)
    if shape.kind == "prefill":
        return trace_prefill(cfg, specs, mesh, device)
    return trace_decode(cfg, specs, mesh, device, shape.seq_len - 1)


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                step_impl: str = "fsdp_norm", accum: int = 1,
                remat: str = "full", variance_impl: str = "scalar",
                seqpar: bool = False, bucket_ladder: str = "",
                device: str = "cuda"):
    """Trace one combination as rank 0 of a fake 256- or 512-rank group;
    returns (trace, record).  `seqpar` applies to FSDP-Norm train shapes
    only, as in the reference; the record says whether it applied."""
    device = resolve_trace_device(device)
    cfg = dryrun_config(arch, remat=remat)
    shape = INPUT_SHAPES[shape_name]
    seqpar = seqpar and shape.kind == "train" and step_impl == "fsdp_norm"
    init_fake_workers(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.size
        kw = dict(step_impl=step_impl, variance_impl=variance_impl,
                  seqpar=seqpar)
        tr, expected = trace_combo(cfg, shape, mesh, device, accum=accum, **kw)
        ladder_rec = {}
        if bucket_ladder and shape.kind == "train":
            for m in (int(v) for v in bucket_ladder.split(",")):
                if m == accum or shape.global_batch % m != 0:
                    continue
                rung, _ = trace_combo(cfg, shape, mesh, device, accum=m, **kw)
                ladder_rec[f"M{m}"] = {
                    "peak_bytes": rung.memory["peak_bytes"],
                    "fits": rung.memory["fits"],
                    "flops": rung.cost["flops"],
                    "trace_s": round(rung.seconds, 2)}
        workers = num_workers(mesh)
    finally:
        dist.destroy_process_group()
    mflops = roofline.model_flops_per_step(cfg, shape, n_dev)
    rl = roofline.roofline_terms(tr.cost, tr.collectives, mflops)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "step_impl": step_impl if shape.kind == "train" else shape.kind,
        "seqpar": seqpar,
        "devices": n_dev,
        "workers_J": workers,
        "device": str(device),
        "compile_s": None,          # eager: nothing is compiled
        "trace_s": round(tr.seconds, 2),
        "memory": {**tr.memory, "param_spec_bytes": expected},
        "cost": tr.cost,
        "collectives": tr.collectives,
        "wire_bytes_by_link": roofline.wire_bytes_by_link(tr.collectives),
        "kernel_calls": tr.kernel_calls,
        "roofline": rl.as_dict(),
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    if ladder_rec:
        record["bucket_ladder"] = ladder_rec
    return tr, record


def applicable(arch: str, shape_name: str) -> bool:
    """All 40 pairs are traced: long_500k uses the native sub-quadratic
    path for SSM/hybrid archs and the sliding-window serving mode for the
    rest (DESIGN §4)."""
    return True


def _tag(arch: str, shape_name: str, multi_pod: bool, args) -> str:
    tag = f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
    if args.step_impl != "fsdp_norm":
        tag += f"__{args.step_impl}"
    if args.seqpar:
        tag += "__seqpar"
    if args.tag:
        tag += f"__{args.tag}"
    return tag


def _run_one(args, arch: str, shape_name: str, multi_pod: bool):
    """Trace one combination and write its record (or, on a failure, its
    traceback as `.fail`); returns (tag, line to print, error or None)."""
    tag = _tag(arch, shape_name, multi_pod, args)
    path = os.path.join(args.out, tag + ".json")
    try:
        _, rec = lower_combo(
            arch, shape_name, multi_pod, step_impl=args.step_impl,
            accum=args.accum, remat=args.remat,
            variance_impl=args.variance_impl, seqpar=args.seqpar,
            bucket_ladder=args.bucket_ladder, device=args.device)
    except Exception as e:
        with open(path + ".fail", "w") as f:
            f.write(traceback.format_exc())
        return tag, f"  FAIL: {e!r}", repr(e)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    rl, mem = rec["roofline"], rec["memory"]
    return tag, (f"  ok: trace={rec['trace_s']}s "
                 f"peak={mem['peak_bytes'] / 1e9:.3f}GB fits={mem['fits']} "
                 f"flops/dev={rl['flops']:.3g} bottleneck={rl['bottleneck']}"), None


def summarize(out_dir: str) -> str:
    """A Markdown grid of the records under `out_dir`, a row per (arch,
    step) and a column per input shape; a cell holds each mesh's peak GB
    a rank (✗ past the card's memory), the bottleneck and the trace
    seconds, then, on 16 × 16, TFLOP · GB accessed · wire GB a rank
    (all-reduce + all-gather, + the other kinds where there are any).  A
    row's step carries "seqpar" where sequence parallelism applied (train
    shapes; the other shapes' records are the same without it).  The
    `.fail` files are listed."""
    recs = {}
    names = sorted(os.listdir(out_dir))
    for name in names:
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            row = rec["arch"] + (f" ({rec['step_impl']})"
                                 if rec["step_impl"] == "accum_norm" else "")
            if rec["shape"].startswith("train") and rec.get("seqpar"):
                row += " (seqpar)"
            recs.setdefault(row, {})[(rec["shape"], rec["mesh"])] = rec

    def cell(by, sh):
        got = [r for r in (by.get((sh, m)) for m in ("16x16", "2x16x16")) if r]
        if not got:
            return "—"
        peaks = " / ".join(f"{r['memory']['peak_bytes'] / 1e9:.2f}"
                           + ("" if r["memory"]["fits"] else " ✗") for r in got)
        bott = "/".join(sorted({r["roofline"]["bottleneck"] for r in got}))
        r = got[0]
        wire = roofline.wire_bytes_by_kind(r["collectives"])
        ar, ag = wire.pop("all-reduce") / 1e9, wire.pop("all-gather") / 1e9
        other = sum(wire.values()) / 1e9
        return (f"{peaks}, {bott}, {max(x['trace_s'] for x in got):.3g} s; "
                f"{r['roofline']['flops'] / 1e12:.3g} · "
                f"{r['roofline']['hbm_bytes'] / 1e9:.3g} · {ar:.3g} + {ag:.3g}"
                + (f" + {other:.3g}" if other else ""))

    shapes = list(INPUT_SHAPES)
    rows = ["| peak GB a rank 16 × 16 / 2 × 16 × 16, bottleneck, trace; on "
            "16 × 16 TFLOP · GB accessed · wire GB (all-reduce + all-gather) | "
            + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for row, by in recs.items():
        rows.append(f"| {row} | " + " | ".join(cell(by, sh) for sh in shapes) + " |")
    fails = [n.removesuffix(".json.fail") for n in names if n.endswith(".fail")]
    rows += ["", "Failed: " + (", ".join(fails) if fails else "none")]
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=ALL_ARCHS)
    p.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--assigned-only", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--step-impl", default="fsdp_norm",
                   choices=("fsdp_norm", "accum_norm"))
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--remat", default="full")
    p.add_argument("--variance-impl", default="scalar")
    p.add_argument("--bucket-ladder", default="",
                   help="comma list of accumulation rungs to trace, e.g. "
                        "'1,2,4,8' (train shapes only)")
    p.add_argument("--seqpar", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda': fake CUDA tensors, the card's kernels "
                        "(needs a torch with CUDA); 'cpu': the plain versions")
    p.add_argument("--jobs", type=int, default=1,
                   help="trace the combinations in this many processes")
    p.add_argument("--tag", default="")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--summarize", default=None, metavar="DIR",
                   help="print a Markdown table of the records under DIR, "
                        "trace nothing")
    args = p.parse_args(argv)
    if args.summarize:
        print(summarize(args.summarize))
        return
    resolve_trace_device(args.device)

    archs = [args.arch] if args.arch else (
        list(ASSIGNED_ARCHS) if (args.all or args.assigned_only) else [])
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    combos = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = _tag(arch, shape_name, mp, args)
                if args.skip_existing and os.path.exists(
                        os.path.join(args.out, tag + ".json")):
                    print(f"[skip] {tag}")
                    continue
                combos.append((arch, shape_name, mp))
    failures = []
    if args.jobs > 1:
        # each combination in a process of its own pool: a fake group a
        # process, no state shared
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            futures = [pool.submit(_run_one, args, *c) for c in combos]
            for fut in as_completed(futures):
                tag, line, err = fut.result()
                print(f"[dryrun] {tag}\n{line}", flush=True)
                if err:
                    failures.append((tag, err))
    else:
        for c in combos:
            print(f"[dryrun] {_tag(*c, args)} ...", flush=True)
            tag, line, err = _run_one(args, *c)
            print(line, flush=True)
            if err:
                failures.append((tag, err))
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("\nall combinations traced OK")


if __name__ == "__main__":
    main()
