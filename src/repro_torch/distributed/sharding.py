"""Logical-axis sharding rules, the tensor-parallel hooks, and flat-buffer
sharding over the data workers (counterpart of
`repro/distributed/sharding.py`, and of the shard view of
`repro/distributed/train_step.py::_shard_bucket`).

Rules.  Model code names the logical axes of a tensor ("batch", "heads",
"ffn", ...); a `ShardingRules` maps them to mesh axes.  A spec is a plain
tuple whose entries are None, an axis name or a tuple of names — what
`tuple(PartitionSpec(...))` gives in the reference.

Tensor parallelism.  The reference constrains activations at its
`maybe_shard` points and lets GSPMD insert the collectives over `model`.
The port holds each rank's shard explicitly and places the collectives by
hand (Megatron-style), at those same points, through two autograd
functions over the active mesh's model group:

* `tp_enter` — the column-parallel entry: identity forward; the input's
  gradient all-reduced over the model group backward (each rank's
  projections saw only its own heads or ffn columns);
* `maybe_shard` — at the reference's row-parallel exits (attention's and
  the MLP's output, spec replicated over `model`): the rank's partial sum
  all-reduced forward; identity backward;
* `tp_gather` — this rank's slice all-gathered whole along a dim; backward
  its slice of a gradient that every rank holds the same (SSD's cut
  leaves, whole for a block that runs whole; RG-LRU's conv output, behind
  `tp_enter`, whole for the gates' products).

Outside `use_sharding_rules(rules, mesh)`, or with a model axis of size
1, both are the identity and the model computes what it always did.

Sequence parallelism (`with_sequence_parallel` rules, `seq_parallel()`):
the residual stream between TP regions holds only this rank's slice of
the sequence (dim 1: the stream zero-padded to a multiple of M, rank m
holding rows [m·c, (m+1)·c), c = ceil(t / M)), so the norms, post-norms
and residual adds run on 1/M of it.  This is what GSPMD makes of the
reference's `act_seq` constraint at the two TP boundaries of a block:

* `stream_enter` — the column-parallel entry from the stream: the slices
  all-gathered (trimmed to t) forward; the whole input's gradient, a
  partial sum over the model group, reduce-scattered backward;
* `maybe_shard`'s exits and `stream_exit` — a partial sum reduce-scattered
  into this rank's slice forward; the slices' gradients all-gathered
  backward;
* `stream_gather` / `stream_scatter` — the stream made whole for a region
  that runs whole on every rank (MoE's router, MLA's latents, SSD, the
  encoder's output, the cross-entropy), and a whole tensor cut to this
  rank's slice; backward, the slice of a gradient every rank holds the
  same, and the slices' gradients all-gathered.

A gather trims to the stream's true length, which the layer running it
declares (`stream_length`, from its whole `positions`).  The
reduce-scatter is `reduce_scatter_tensor` on every backend: gloo runs it
on CPU and on CUDA tensors (torch 2.11 on the H100), nccl and the
dry-run's fake group natively.

Flat buffers.  Bucket buffers are padded to a J-divisible size
(`FlatLayout.from_tree(..., shard_divisor=J)`), so worker j's shard of a
bucket of n·J elements is the contiguous slice [j·n, (j+1)·n) — the order
the reference's `P(daxes)` lays shards out in; they are whole across
`model` (`flat_buffer_specs`).  Flat parameters REST as the worker's
shards; the step all-gathers them over the data group before the forward.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import MODEL, group_size, num_workers, worker_index

MeshAxes = tuple[str, ...] | str | None


def entry_axes(entry: MeshAxes) -> tuple:
    """The axes of one spec dim as a tuple (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(axes: MeshAxes) -> MeshAxes:
    """One dim of a spec as `PartitionSpec` normalizes it: no axes is None,
    one axis its name, several a tuple."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to physical mesh axes."""

    rules: dict = field(default_factory=dict)

    def spec(self, logical_axes) -> tuple:
        return tuple(None if name is None else spec_entry(self.rules.get(name))
                     for name in logical_axes)


# The production layout: tensor/expert/vocab dims over the `model` axis,
# batch over the data axes.
DEFAULT_RULES = ShardingRules(
    rules={
        "batch": ("data",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": None,          # d_model replicated (activations)
        "seq": None,
        "kv_seq": None,
        "act_seq": None,        # sequence parallelism: off by default
        "lru_width": ("model",),
        "ssm_heads": ("model",),
        "state": None,
    }
)

MULTIPOD_RULES = ShardingRules(
    rules={**DEFAULT_RULES.rules, "batch": ("pod", "data")}
)


def with_sequence_parallel(rules: ShardingRules) -> ShardingRules:
    """Sequence parallelism: the residual stream's seq dim over the model
    axis between TP regions."""
    return ShardingRules(rules={**rules.rules, "act_seq": ("model",)})


# Full-mesh FSDP layout for ACCUM-NORM: parameters' large dims sharded over
# both axes.
FULL_FSDP_RULES = ShardingRules(
    rules={**DEFAULT_RULES.rules, "param_fsdp": ("data", "model")}
)


def manual_data_rules(rules: ShardingRules, manual_axes) -> ShardingRules:
    """Strip `manual_axes` from every rule (the reference's rules inside a
    region manual over the data axes: FSDP-Norm's workers)."""
    new = {}
    for name, axes in rules.rules.items():
        if axes is None:
            new[name] = None
        elif isinstance(axes, str):
            new[name] = None if axes in manual_axes else axes
        else:
            kept = tuple(a for a in axes if a not in manual_axes)
            new[name] = kept if kept else None
    return ShardingRules(rules=new)


def flat_buffer_specs(num_buffers: int, axes) -> tuple:
    """Per-bucket specs of the flat buffers: the single dim over the data
    axes (buckets are padded to a divisible size); no axes: replicated."""
    spec = (spec_entry(axes),) if axes else ()
    return tuple(spec for _ in range(num_buffers))


# ------------------------------------------------------------ context ----

class _Ctx:
    """The active rules and mesh, and the residual stream's true length
    under sequence parallelism.  Process-wide, not thread-local (as the
    reference's is): on the card autograd runs the backward, and with it a
    checkpointed block's recomputed forward, on its own device thread,
    which must see the hooks the forward saw."""
    rules = None
    mesh = None
    seq_len = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding_rules(rules: ShardingRules | None, mesh=None):
    prev_rules, prev_mesh = _CTX.rules, _CTX.mesh
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev_rules, prev_mesh


def current_rules() -> ShardingRules | None:
    return _CTX.rules


def logical_spec(*logical_axes) -> tuple:
    rules = _CTX.rules
    if rules is None:
        return (None,) * len(logical_axes)
    return rules.spec(tuple(logical_axes))


# ----------------------------------------------------- tensor parallelism ----

# host seconds inside the TP collectives (each gloo call blocks until it is
# done), and their count; of those, the sequence-parallel reduce-scatters
# and all-gathers of the stream; reset by the caller (`reset_tp_stats`)
TP_STATS = {"calls": 0, "seconds": 0.0, "seq_reduce_scatter": 0,
            "seq_all_gather": 0}


def reset_tp_stats():
    TP_STATS.update(calls=0, seconds=0.0, seq_reduce_scatter=0, seq_all_gather=0)


def model_axis():
    """(model group, this rank's model index) of the active mesh when its
    model axis has more than one rank and the rules shard over it; else
    None."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if (mesh is None or rules is None or mesh.model_size == 1
            or MODEL not in entry_axes(rules.rules.get("heads"))):
        return None
    return mesh.model_group, mesh.model_index


def model_size() -> int:
    """The active model axis's size (1 when `model_axis` is None)."""
    return 1 if model_axis() is None else _CTX.mesh.model_size


def seq_parallel() -> bool:
    """Whether the active rules put the residual stream's sequence
    (`act_seq`) on a model axis of more than one rank."""
    return (model_axis() is not None
            and MODEL in entry_axes(_CTX.rules.rules.get("act_seq")))


@contextlib.contextmanager
def stream_length(t: int):
    """Declare the residual stream's true length `t` (its positions') for
    the gathers of the layer run inside."""
    prev, _CTX.seq_len = _CTX.seq_len, t
    try:
        yield
    finally:
        _CTX.seq_len = prev


def _stream_len() -> int:
    if _CTX.seq_len is None:
        raise RuntimeError("a sequence-parallel gather outside `stream_length`: "
                           "the stream's true length is not declared")
    return _CTX.seq_len


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    y = x.contiguous().clone()
    if group_size(group) > 1:
        t0 = time.perf_counter()
        dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
        TP_STATS["calls"] += 1
        TP_STATS["seconds"] += time.perf_counter() - t0
    return y


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=group)
    TP_STATS["calls"] += 1
    TP_STATS["seconds"] += time.perf_counter() - t0
    return torch.cat(parts, dim=dim)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x zero-padded along dim 1 to n rows."""
    return x if x.shape[1] == n else torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 2) + (0, n - x.shape[1]))


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of x (b, c·M, ...), this rank's rows [m·c,
    (m+1)·c) of it (m its index in the group)."""
    rows = x.movedim(1, 0).contiguous()
    y = rows.new_empty((rows.shape[0] // group_size(group),) + rows.shape[1:])
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(y, rows, group=group)
    y = y.movedim(0, 1).contiguous()
    TP_STATS["calls"] += 1
    TP_STATS["seq_reduce_scatter"] += 1
    TP_STATS["seconds"] += time.perf_counter() - t0
    return y


def _gather_rows(x: torch.Tensor, group, t: int) -> torch.Tensor:
    """The ranks' slices all-gathered along dim 1, trimmed to t rows."""
    TP_STATS["seq_all_gather"] += 1
    return _all_gather(x, group, 1).narrow(1, 0, t).contiguous()


def _slice_rows(x: torch.Tensor, m: int, index: int) -> torch.Tensor:
    """This rank's slice of the stream x (b, t, ...) zero-padded to M·c."""
    c = -(-x.shape[1] // m)
    return _pad_rows(x, m * c).narrow(1, index * c, c).contiguous()


class _SeqExit(torch.autograd.Function):
    """Reduce-scatter along the sequence forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        m = group_size(group)
        ctx.group, ctx.t = group, x.shape[1]
        return _reduce_scatter(_pad_rows(x, m * -(-x.shape[1] // m)), group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.group, ctx.t), None


class _SeqEnter(torch.autograd.Function):
    """All-gather along the sequence forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group, t):
        ctx.group, ctx.rows = group, x.shape[1]
        return _gather_rows(x, group, t)

    @staticmethod
    def backward(ctx, grad):
        m = group_size(ctx.group)
        return _reduce_scatter(_pad_rows(grad, m * ctx.rows), ctx.group), None, None


class _SeqGather(torch.autograd.Function):
    """All-gather along the sequence forward; backward, this rank's slice
    of a gradient every rank holds the same."""

    @staticmethod
    def forward(ctx, x, group, index, t):
        ctx.m, ctx.index = group_size(group), index
        return _gather_rows(x, group, t)

    @staticmethod
    def backward(ctx, grad):
        return _slice_rows(grad, ctx.m, ctx.index), None, None, None


class _SeqScatter(torch.autograd.Function):
    """This rank's slice of a tensor every rank holds the same forward;
    the slices' gradients all-gathered backward."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.t = group, x.shape[1]
        return _slice_rows(x, group_size(group), index)

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.group, ctx.t), None, None


def stream_enter(x: torch.Tensor) -> torch.Tensor:
    """The column-parallel entry from the residual stream: under sequence
    parallelism the slices all-gathered whole (gradient reduce-scattered);
    else `tp_enter`."""
    if not seq_parallel():
        return tp_enter(x)
    return _SeqEnter.apply(x, model_axis()[0], _stream_len())


def stream_exit(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over the model group made whole into the stream:
    under sequence parallelism reduce-scattered into this rank's slice
    (gradient all-gathered); else `tp_reduce`."""
    if not seq_parallel():
        return tp_reduce(x)
    return _SeqExit.apply(x, model_axis()[0])


def stream_gather(x: torch.Tensor) -> torch.Tensor:
    """The stream whole on every rank for a region that runs whole (its
    gradient the same on every rank): under sequence parallelism the
    slices all-gathered and trimmed to the declared `stream_length`; else
    x."""
    if not seq_parallel():
        return x
    group, index = model_axis()
    return _SeqGather.apply(x, group, index, _stream_len())


def stream_scatter(x: torch.Tensor) -> torch.Tensor:
    """A tensor every rank holds the same, cut to this rank's slice of the
    stream under sequence parallelism; else x."""
    if not seq_parallel():
        return x
    group, index = model_axis()
    return _SeqScatter.apply(x, group, index)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // group_size(ctx.group)
        return grad.narrow(ctx.dim, ctx.index * n, n).contiguous(), None, None, None


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a tensor all-gathered whole along `dim` (the
    ranks' slices in model order); backward, this rank's slice of the
    gradient, which must be the same on every rank (what follows runs
    whole).  The identity without a model axis."""
    tp = model_axis()
    return x if tp is None else _Gather.apply(x, tp[0], tp[1], dim)


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """The column-parallel entry (identity forward, gradient all-reduced
    over the model group backward); the identity without a model axis."""
    tp = model_axis()
    return x if tp is None else _Enter.apply(x, tp[0])


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over the model group made whole: all-reduced forward,
    identity backward (every rank holds the same result, so each passes
    the loss's gradient to its own part)."""
    tp = model_axis()
    return x if tp is None else _Exit.apply(x, tp[0])


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """Element-wise max over the model group, outside autograd."""
    tp = model_axis()
    return x.detach() if tp is None else _all_reduce(x.detach(), tp[0],
                                                     dist.ReduceOp.MAX)


def maybe_shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """At the reference's row-parallel exits: a tensor whose spec leaves
    every dim off `model` is this rank's partial sum of a product over its
    heads or ffn columns, all-reduced here (`tp_reduce`), or under
    sequence parallelism reduce-scattered into this rank's slice of the
    stream (`stream_exit`).  A spec with a dim on `model` names a tensor
    that already is this rank's shard: the identity.  Outside a model
    axis: the identity.  Inside `checkpoint_tp_boundary` the reduced
    result is kept, and the backward pass's recompute takes it instead of
    reducing again."""
    tp = model_axis()
    if tp is None or any(MODEL in entry_axes(a)
                         for a in logical_spec(*logical_axes)):
        return x
    exit_ = stream_exit if seq_parallel() else (lambda v: _Exit.apply(v, tp[0]))
    b = _BOUNDARY[0]
    if b is None:
        return exit_(x)
    if b.replay:
        b.i += 1
        return _Replay.apply(x, b.saved[b.i - 1],
                             tp[0] if seq_parallel() else None)
    y = exit_(x)
    b.saved.append(y.detach())
    return y


class _Replay(torch.autograd.Function):
    """A row-parallel exit's kept result in place of its all-reduce (or
    reduce-scatter: `group` given, and the backward all-gathers, as the
    exit's does)."""

    @staticmethod
    def forward(ctx, x, kept, group):
        ctx.group, ctx.t = group, x.shape[1]
        return kept.clone()

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is not None:
            grad = _gather_rows(grad, ctx.group, ctx.t)
        return grad, None, None


class _Boundary:
    def __init__(self):
        self.saved, self.replay, self.i = [], False, 0


_BOUNDARY = [None]       # the block `checkpoint_tp_boundary` is running


def checkpoint_tp_boundary(fn, *args):
    """`fn(*args)` (a layer) under activation checkpointing that keeps only
    the outputs of its row-parallel exits (the reference's
    remat="tp_boundary", which saves its "tp_out" names): the backward pass
    recomputes the layer from its inputs, each exit taking its kept result
    (under sequence parallelism the reduce-scattered slice), so no forward
    all-reduce or reduce-scatter runs twice.  Without a model axis there is no
    exit and this is full recomputation."""
    b = _Boundary()

    def run(*a):
        prev, _BOUNDARY[0] = _BOUNDARY[0], b
        b.i = 0
        try:
            return fn(*a)
        finally:
            _BOUNDARY[0] = prev
            b.replay = True

    return checkpoint(run, *args, use_reentrant=False)


# -------------------------------------------------------- flat buffers ----

def shard_bucket(b: torch.Tensor, idx: int, J: int) -> torch.Tensor:
    """Worker `idx`'s 1/J slice of one J-divisible bucket, as a view (J = 1:
    the bucket itself)."""
    if J == 1:
        return b
    n = b.shape[0] // J
    return b[idx * n:(idx + 1) * n]


def shard_flat_buffers(buffers, mesh=None):
    """This worker's shard of each bucket, each its own tensor (a copy, so
    that no shard aliases a full buffer it is gathered into); one worker:
    the buffers themselves.  Workers are the mesh's data coordinates (no
    mesh: the process group's ranks)."""
    J = num_workers(mesh)
    if J == 1:
        return list(buffers)
    idx = worker_index(mesh)
    return [shard_bucket(b, idx, J).clone() for b in buffers]


def gather_flat_buffers(shards, out=None, mesh=None):
    """All-gather each bucket's shards over the data group into the full
    buffer, one `all_gather_into_tensor` per bucket, into `out` when given
    (fresh buffers otherwise).  One worker: the shards are the full
    buffers."""
    J = num_workers(mesh)
    if J == 1:
        return list(shards)
    group = None if mesh is None else mesh.data_group
    if out is None:
        out = [s.new_empty(s.numel() * J) for s in shards]
    for full, s in zip(out, shards):
        dist.all_gather_into_tensor(full, s, group=group)
    return list(out)


__all__ = [
    "ShardingRules", "DEFAULT_RULES", "MULTIPOD_RULES", "FULL_FSDP_RULES",
    "entry_axes", "spec_entry", "with_sequence_parallel", "manual_data_rules",
    "flat_buffer_specs",
    "use_sharding_rules", "current_rules", "logical_spec", "maybe_shard",
    "model_axis", "model_size", "tp_enter", "tp_reduce", "tp_max", "tp_gather", "TP_STATS",
    "reset_tp_stats", "seq_parallel", "stream_length",
    "stream_enter", "stream_exit", "stream_gather", "stream_scatter",
    "checkpoint_tp_boundary",
    "shard_bucket", "shard_flat_buffers", "gather_flat_buffers",
]
