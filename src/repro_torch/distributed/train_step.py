"""Train steps (counterpart of `repro/distributed/train_step.py`).

* `make_fsdp_norm_step` — the paper's DDP-/FSDP-Norm: J workers, one
  `torch.distributed` rank each (`launch/mesh.py`).  Each worker takes its
  slice of the global batch, accumulates its minibatch gradient g_j, and
  the workers' valid-token-weighted mean g is all-reduced; the eq. (5)
  statistic comes from g_j and g.  With J = 1 there is no collective.
* `make_accum_norm_step` — beyond-paper ACCUM-NORM: the variance
  statistic comes from the M gradient-accumulation microbatch gradients.
  On one rank it needs no collective; over J data ranks each microbatch
  spans every worker, its gradient averaged over them before ‖ĝ^m‖² (as
  the reference's GSPMD step does inside its scan).

Both take `mesh=` (`launch/mesh.py`): J is then the mesh's data workers
and M its model axis.  Without a mesh FSDP-Norm's workers are the process
group's ranks and ACCUM-NORM runs on one rank, as before.  Under a model
axis the model runs tensor-parallel (`distributed/sharding.py`) on each
rank's slices of the leaves (`distributed/params.py`):

* FSDP-Norm, tree residency: params and moments rest as the
  `param_pspecs(fsdp=False)` slices; a replicated leaf used inside a
  sharded attention (`model_roles` "partial") has its gradient summed over
  the model group; the statistic and the clip count every replicated leaf
  once.  Flat residency: the same `FlatLayout` as at M = 1, buckets whole
  across `model` and sharded over the data workers; the forward runs on
  TP views of the gathered buffers, and each rank's gradient buffers are
  made whole over the model group before the statistic.
* ACCUM-NORM, tree residency: params and moments rest as the
  `param_pspecs(fsdp=True)` slices (ZeRO-3: the "F" dims over the data
  workers), gathered over the data group each step.  Flat residency:
  buckets sharded over the data workers, the AdamW kernel on the shard,
  the clip from the summed Σg².

* The mixed residencies on a grid: the gradient is born flat, as on the
  flat/flat path (whole buffers, made whole over the model group), and
  the other half follows its residency.  Stats flat with params tree: the
  flat tail updates this worker's shard of the params packed whole
  (gathered over the model group, and for ACCUM-NORM its data workers),
  and the rank keeps its slices of the result.  Stats tree with params
  flat: the tree oracle runs on the whole views, with whole moment trees,
  and the worker keeps its shard of the packed result.

Both take a stacked-microbatch batch {tokens/labels: (M, B_global, seq)}
and perform: accumulate grads over M -> statistic -> AdamW -> metrics.

Two residency switches (`stats_impl`, `params_impl`), all four
combinations:

* ('tree', 'tree') — the oracle: params are a tree of leaf tensors, the
  gradient accumulates into a tree of f32 tensors, AdamW runs leaf by leaf.
* ('flat', 'flat') — DESIGN §9/§10: params live in bucket buffers and the
  model runs on views into them (`FlatLayout.unflatten`); each
  microbatch's leaf gradients are added straight into congruent views of
  persistent f32 gradient buffers, so the gradient is born flat with no
  pack; the statistic and the AdamW tail each run one kernel launch over
  every bucket (per dtype group), IN PLACE on the param and moment buffers
  (where the reference donates them).  Under
  FSDP-Norm the params and moments rest as the worker's 1/J shard of each
  bucket: the step all-gathers the params, and each worker updates its
  own shard.
* ('flat', 'tree') — tree-resident params with the flat tail: the mean
  gradient and the params are packed once a step against the shared
  layout, the statistic and the AdamW update run on the buffers (under
  FSDP-Norm on the worker's 1/J shard, its moments a shard too), and the
  updated params come back as views of the (all-gathered) buffers.
* ('tree', 'flat') — flat-resident params with the tree-oracle tail: the
  gradient is born flat, the statistic and AdamW run leaf by leaf on the
  tree views, and the updated tree is packed back (under FSDP-Norm: the
  worker's shard of it).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.norm_test import (
    accum_variance_stats, paper_faithful_worker_variance, tree_sqnorm,
    worker_variance_stats, worker_variance_stats_buffers,
    worker_variance_stats_flat)
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.distributed.params import (
    gather_tree, map_specs, model_roles, param_pspecs, shard_tree, strip_spec)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, MULTIPOD_RULES, flat_buffer_specs, gather_flat_buffers,
    manual_data_rules, shard_bucket, shard_flat_buffers, use_sharding_rules,
    with_sequence_parallel)
from repro_torch.launch.mesh import (
    MODEL, data_axes, num_workers, psum, worker_index)
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, adamw_update_buffers, clip_scale_from_norm)
from repro_torch.tracing import span
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _check_impls(stats_impl: str, params_impl: str):
    for name, val in (("stats_impl", stats_impl), ("params_impl", params_impl)):
        if val not in ("tree", "flat"):
            raise ValueError(f"{name} must be 'tree' or 'flat', got {val!r}")


def batch_to_device(batch, device):
    """numpy stacked batch -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _in_step_span(step):
    """`step` called inside the `step` span (`repro_torch.tracing`)."""
    @functools.wraps(step)
    def spanned(params, opt_state, batch, lr):
        with span("step"):
            return step(params, opt_state, batch, lr)
    return spanned


def _accumulate(loss_fn, params, batch, track_micro_sqnorm: bool, acc_g):
    """Loop over the M stacked microbatches, adding each microbatch's
    gradient, weighted by its VALID-TOKEN count w (labels >= 0), into the
    f32 accumulator leaves `acc_g` (zeroed by the caller), in place.

    Per microbatch the gradient comes from `torch.autograd.grad`, so its
    squared norm ‖ĝ^m‖² is available before it is added: Σ_m ‖ĝ^m‖² counts
    only microbatches with w > 0 (a fully padded microbatch carries no
    gradient draw), and m_eff counts them.  The accumulated gradient is
    finally divided by max(Σw, 1), so padded and unpadded batches give the
    same loss and gradient.  Returns (loss, aux, Σ_m‖ĝ^m‖², m_eff, Σw) as
    0-d tensors."""
    leaves, treedef = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(treedef, xs)
    device = xs[0].device
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    acc_loss, acc_aux, acc_sq, acc_w, acc_m = (zero() for _ in range(5))
    for i in range(batch["tokens"].shape[0]):
        mb = {k: v[i] for k, v in batch.items()}
        with span("step.forward"):
            loss, metrics = loss_fn(tree, mb)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, xs)
        with span("step.accumulate"), torch.no_grad():
            w = (mb["labels"] >= 0).sum().float()
            for a, g in zip(acc_g, grads):
                a.add_(w * g.float())
            if track_micro_sqnorm:
                acc_sq += torch.where(w > 0, tree_sqnorm(list(grads)), 0.0)
            acc_loss += w * loss.detach()
            acc_aux += w * metrics["aux"].detach()
            acc_w += w
            acc_m += (w > 0).float()
    denom = torch.clamp(acc_w, min=1.0)
    with torch.no_grad():
        for a in acc_g:
            a.div_(denom)
    return acc_loss / denom, acc_aux / denom, acc_sq, acc_m, acc_w


# ------------------------------------------------------------- grid ----

class _Grid:
    """A step's view of its mesh: J, j and the data group; M, m and the
    model group; the rules the model runs under; the specs that cut whole
    leaves into this rank's tensor-parallel slices, and each leaf's part
    under the model axis (`params.model_roles`).  `sequence_parallel`: the
    rules put the residual stream's sequence on the model axis (the
    reference's `with_sequence_parallel`), and the stream's norms are
    "partial"."""

    def __init__(self, mesh, params_like, model_specs, manual: bool,
                 sequence_parallel: bool = False):
        self.mesh = mesh
        self.J, self.idx = num_workers(mesh), worker_index(mesh)
        self.m = mesh.model_index
        self.dg, self.mg = mesh.data_group, mesh.model_group
        self.daxes = data_axes(mesh)
        base = MULTIPOD_RULES if "pod" in mesh.axis_names else DEFAULT_RULES
        if sequence_parallel:
            base = with_sequence_parallel(base)
        self.rules = manual_data_rules(base, self.daxes) if manual else base
        self.model_specs = model_specs
        roles = tree_flatten(model_roles(params_like, model_specs,
                                         sequence_parallel))[0]
        self.partial = [r == "partial" for r in roles]
        self.once_mask = [r == "sharded" or self.m == 0 for r in roles]
        self.copies = [r == "replicated" and self.m != 0 for r in roles]

    def rules_on(self):
        return use_sharding_rules(self.rules, self.mesh)

    def local(self, tree):
        """This rank's tensor-parallel views of whole leaves."""
        return shard_tree(tree, self.model_specs, self.mesh, axes=(MODEL,))

    def born_flat(self, buffers, layout):
        """The leaves of this rank's gradient, as views of whole-layout
        buffers (zeroed here) that `make_whole` then sums."""
        for b in buffers:
            b.zero_()
        return tree_leaves(self.local(layout.unflatten(buffers)))

    def make_whole(self, buffers, layout):
        """Whole gradient buffers from every rank's slices: the replicated
        leaves' copies off model index 0 dropped, then a sum over the model
        group (a sharded leaf's slices are disjoint, a partial leaf's
        shares add up)."""
        self.drop_copies(buffers, layout)
        for b in buffers:
            psum(b, self.mg)

    def once(self, leaves):
        """The leaves this rank counts in a sum over the model group: its
        slices, and the replicated leaves on model index 0 only."""
        return [x for x, keep in zip(leaves, self.once_mask) if keep]

    def sum_partial(self, leaves):
        for x, partial in zip(leaves, self.partial):
            if partial:
                psum(x, self.mg)

    def drop_copies(self, buffers, layout):
        """Zero the slots of replicated leaves off model index 0, so that a
        sum over the model group counts them once."""
        for slot, copy in zip(layout.slots, self.copies):
            if copy:
                buffers[slot.buffer_index][
                    slot.offset:slot.offset + slot.size].zero_()


def _tp_grid(mesh, params_like, *, fsdp: bool, manual: bool,
             sequence_parallel: bool = False):
    """(the step's `_Grid`, the specs its tree params rest in), or None
    where the mesh adds nothing to the single-axis step (no mesh; FSDP-Norm
    with no model axis; ACCUM-NORM on one rank)."""
    if mesh is None:
        return None
    if mesh.coords is None:
        raise ValueError(f"{mesh!r} describes a layout only: build it "
                         f"inside a process group of {mesh.size} ranks")
    if mesh.model_size == 1 and (manual or num_workers(mesh) == 1):
        return None
    specs = param_pspecs(params_like, mesh, fsdp=fsdp)
    model_specs = map_specs(lambda sp: strip_spec(sp, data_axes(mesh)), specs)
    return _Grid(mesh, params_like, model_specs, manual,
                 sequence_parallel), specs


def _contiguous_copy(tree):
    return tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                    tree)


# --------------------------------------------------------- FSDP-Norm ----

def worker_batch(batch, idx: int, J: int):
    """Worker `idx`'s contiguous slice of the global-batch dim (dim 1) of
    every (M, B, ...) leaf — what the reference's `P(None, daxes)` gives
    each worker; other leaves are replicated."""
    if J == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.dim() < 2:
            out[k] = v
            continue
        if v.shape[1] % J:
            raise ValueError(f"batch leaf {k!r}: global batch {v.shape[1]} "
                             f"does not split over {J} workers")
        n = v.shape[1] // J
        out[k] = v[:, idx * n:(idx + 1) * n]
    return out


def worker_mean(local, w_j, out, group=None):
    """The valid-token-weighted mean over the workers (the data `group`),
    into the tensors `out`: out_i = Σ_j(local_i·w_j) / max(Σ_j w_j, 1).  It
    equals the plain mean on unpadded batches and stays exact when the
    padded tail of a bucketed batch lands unevenly across workers (DESIGN
    §8).  One worker runs the same arithmetic with no collective.  Returns
    max(Σ_j w_j, 1)."""
    w_sum = torch.clamp(psum(w_j.clone(), group), min=1.0)
    for o, x in zip(out, local):
        psum(o.copy_(x).mul_(w_j), group).div_(w_sum)
    return w_sum


def _sharded_buffer_update(pb_local, gb, opt_state, opt_cfg, lr,
                           grad_sqnorm, idx: int, J: int):
    """FSDP-style sharded flat AdamW (DESIGN §9/§10): the worker's param and
    moment shards are updated IN PLACE from its 1/J slice of the mean
    gradient buffers.  `grad_sqnorm` is the global Σ‖g‖² from the
    statistics: the clip needs the GLOBAL norm, which a per-shard kernel
    byproduct could not give.  Returns (param shards, opt state, grad
    norm)."""
    gb_local = [shard_bucket(b, idx, J) for b in gb]
    _, new_mb, new_vb, count, gnorm, _ = adamw_update_buffers(
        list(pb_local), gb_local, list(opt_state["m"]), list(opt_state["v"]),
        opt_cfg, lr, opt_state["count"], grad_sqnorm=grad_sqnorm)
    return pb_local, {"m": tuple(new_mb), "v": tuple(new_vb),
                      "count": count}, gnorm


def make_fsdp_norm_step(model, opt_cfg: AdamWConfig, *,
                        variance_impl: str = "scalar",
                        stats_impl: str = "tree", params_impl: str = "tree",
                        sequence_parallel: bool = False, params_like=None,
                        device=None, mesh=None, bucket_bytes=None):
    """Build the FSDP-Norm step of this rank (every rank builds and calls
    it in lockstep).  Workers: the `mesh`'s data coordinates (J =
    `num_workers(mesh)`, j = `worker_index(mesh)`); no mesh: the process
    group's ranks.  Returns `wrap`, with `wrap(batch_like)` -> `step(params,
    opt_state, batch, lr) -> (params, opt_state, metrics)`,
    `wrap.flat_layout` the step's shared `FlatLayout` (None on the tree
    path), `wrap.param_specs` the specs its params and moments rest in
    (tree: per leaf; flat: per bucket; None off a grid) and `wrap.grid` its
    view of the mesh (None off a grid).

    variance_impl: 'scalar' (one pre-reduced f32 all-reduce, DESIGN §7.1)
    or 'paper' (eq. 5 literal: all-reduce the full (g_j − g)² vector; tree
    residency only, as in the reference).

    Tree params are whole trees, replicated on every worker — on a model
    axis, this rank's slices (`params.shard_tree(tree, wrap.param_specs,
    mesh)`); flat params are the tuple of the worker's 1/J bucket shards
    (`sharding.shard_flat_buffers` of the packed buffers).  Tree stats keep
    moment trees shaped as the params; flat stats take `opt_state` from
    `init_adamw_flat(layout=wrap.flat_layout)`, whose buffers are shards
    too.  Flat/flat updates params and moments in place and returns them.
    `batch` holds the GLOBAL batch on the params' device; each worker
    takes its own slice.  Metrics are 0-d f32 tensors, equal on every
    rank.  `params_like` is the whole tree; without it the step is built
    from `model.init(0, device)`: on the CUDA card unless `device` names
    another, and it raises without one.

    sequence_parallel: the residual stream between TP regions holds this
    rank's slice of the sequence (the reference's `with_sequence_parallel`
    rules; `distributed/sharding.py`): each TP exit reduce-scatters and
    each entry all-gathers, and the stream's norms run on the slice, their
    gradients summed over the model group.  Nothing changes without a
    model axis.

    bucket_bytes: the flat layout's bucket size (default: the device's,
    `flatbuf.default_bucket_bytes`)."""
    _check_impls(stats_impl, params_impl)
    if variance_impl not in ("scalar", "paper"):
        raise ValueError(f"variance_impl must be 'scalar' or 'paper', got "
                         f"{variance_impl!r}")
    if variance_impl == "paper" and stats_impl == "flat":
        raise ValueError("variance_impl='paper' (full-vector all-reduce "
                         "baseline) has no flat-buffer path; use "
                         "stats_impl='tree'")
    if variance_impl == "paper" and params_impl == "flat":
        raise ValueError("variance_impl='paper' walks tree-resident gradient "
                         "leaves; use params_impl='tree'")
    if params_like is None:
        params_like = model.init(0, device)
    if device is None:
        device = tree_flatten(params_like)[0][0].device
    device = torch.device(device)
    grid = _tp_grid(mesh, params_like, fsdp=False, manual=True,
                    sequence_parallel=sequence_parallel)
    J, idx = num_workers(mesh), worker_index(mesh)
    dg = None if mesh is None else mesh.data_group
    if grid is not None:
        grid, tree_specs = grid
    # ONE layout per step, shared by the statistics, the AdamW tail and
    # the residency (None on the pure tree path)
    layout = (FlatLayout.from_tree(params_like, bucket_bytes, shard_divisor=J,
                                   device=device)
              if "flat" in (stats_impl, params_impl) else None)
    # the gradient is born flat: flat params, and on a grid any flat half
    born_flat = params_impl == "flat" or (grid is not None and layout is not None)
    bufs = {}        # persistent full params (flat params, J > 1), g_j and g

    @_in_step_span
    def step(params, opt_state, batch, lr):
        batch = worker_batch(batch, idx, J)
        if born_flat and not bufs:
            bufs["g_j"] = layout.zeros(torch.float32, device)
            bufs["g"] = layout.zeros(torch.float32, device)
            bufs["full"] = ([torch.empty(n, dtype=dt, device=device)
                             for n, dt in zip(layout.buffer_sizes,
                                              layout.buffer_dtypes)]
                            if J > 1 and params_impl == "flat" else None)
        if params_impl == "flat":
            # the params rest as this worker's shards: gather the full
            # buffers (one worker: the params are the full buffers)
            with span("step.gather_params"):
                full = layout.unflatten(gather_flat_buffers(
                    params, bufs["full"], mesh))
            tree = full if grid is None else grid.local(full)
        else:
            tree = params
        if born_flat:
            g_j, g = bufs["g_j"], bufs["g"]
            acc = (grid.born_flat(g_j, layout) if grid is not None
                   else tree_leaves(layout.unflatten([b.zero_() for b in g_j])))
        else:
            leaves, treedef = tree_flatten(params)
            g_j = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            g = [torch.empty_like(x) for x in g_j]
            acc = g_j
        if grid is None:
            loss, aux, _, _, w_j = _accumulate(model.loss, tree, batch, False,
                                               acc)
        else:
            with grid.rules_on():
                loss, aux, _, _, w_j = _accumulate(model.loss, tree, batch,
                                                   False, acc)
        with span("step.exchange"):
            if grid is not None and born_flat:
                grid.make_whole(g_j, layout)
            elif grid is not None:
                grid.sum_partial(g_j)
            w_sum = worker_mean(g_j, w_j, g, dg)  # g_j stays: the statistic needs it
        if grid is not None and not born_flat:
            g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
            stats = (paper_faithful_worker_variance if variance_impl == "paper"
                     else worker_variance_stats)
            with span("step.statistic"):
                var_l1, gsq = stats(grid.once(tree_leaves(g_j)),
                                    grid.once(tree_leaves(g)), group=dg,
                                    model_group=grid.mg)
            with span("step.tail"), torch.no_grad():
                new_params, new_opt, gnorm = adamw_update(
                    params, g, opt_state, opt_cfg, lr, grad_sqnorm=gsq)
        elif params_impl == "flat" and stats_impl == "flat":
            with span("step.statistic"):
                var_l1, gsq = worker_variance_stats_buffers(g_j, g, group=dg)
            with span("step.tail"):
                new_params, new_opt, gnorm = _sharded_buffer_update(
                    tuple(params), g, opt_state, opt_cfg, lr, gsq, idx, J)
        elif params_impl == "flat":
            # tree-oracle tail on the whole views, then the worker's shard
            # of the packed result
            g_tree = layout.unflatten(g)
            with span("step.statistic"):
                var_l1, gsq = worker_variance_stats(layout.unflatten(g_j),
                                                    g_tree, group=dg)
            with span("step.tail"):
                with torch.no_grad():
                    new_tree, new_opt, gnorm = adamw_update(
                        full, g_tree, opt_state, opt_cfg, lr)
                new_params = tuple(shard_flat_buffers(layout.flatten(new_tree),
                                                      mesh))
        elif stats_impl == "flat" and grid is not None:
            # the born-flat pair; the params packed whole, the worker
            # updates its shard, and the rank keeps its slices of the result
            with span("step.statistic"):
                var_l1, gsq = worker_variance_stats_buffers(g_j, g, group=dg)
            with span("step.tail"):
                whole = gather_tree(params, tree_specs, mesh, axes=(MODEL,))
                pb_local = [shard_bucket(b, idx, J)
                            for b in layout.flatten(whole)]
                pb_local, new_opt, gnorm = _sharded_buffer_update(
                    pb_local, g, opt_state, opt_cfg, lr, gsq, idx, J)
                new_params = _contiguous_copy(grid.local(layout.unflatten(
                    gather_flat_buffers(pb_local, mesh=mesh))))
        elif stats_impl == "flat":
            # pack g and the params once; the fused pair hands back the
            # packed mean gradient, the worker updates its shard, and the
            # updated shards are gathered into the tree's buffers
            g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
            with span("step.statistic"):
                var_l1, gsq, gb = worker_variance_stats_flat(
                    g_j, g, layout=layout, group=dg)
            with span("step.tail"):
                pb_local = [shard_bucket(b, idx, J)
                            for b in layout.flatten(params)]
                pb_local, new_opt, gnorm = _sharded_buffer_update(
                    pb_local, gb, opt_state, opt_cfg, lr, gsq, idx, J)
                new_params = layout.unflatten(gather_flat_buffers(pb_local,
                                                                  mesh=mesh))
        else:
            g_j, g = tree_unflatten(treedef, g_j), tree_unflatten(treedef, g)
            stats = (paper_faithful_worker_variance if variance_impl == "paper"
                     else worker_variance_stats)
            with span("step.statistic"):
                var_l1, gsq = stats(g_j, g, group=dg)
            with span("step.tail"), torch.no_grad():
                new_params, new_opt, gnorm = adamw_update(params, g, opt_state,
                                                          opt_cfg, lr)
        with span("step.metrics"):
            # the workers' token-weighted loss and aux, in one collective
            loss, aux = psum(torch.stack([loss * w_j, aux * w_j]), dg) / w_sum
            metrics = {"loss": loss, "aux": aux, "var_l1": var_l1,
                       "grad_sqnorm": gsq, "grad_norm": gnorm,
                       "clip_scale": clip_scale_from_norm(gnorm,
                                                          opt_cfg.grad_clip)}
        return new_params, new_opt, metrics

    def wrap(batch_like=None):
        return step

    wrap.flat_layout = layout
    wrap.mesh = mesh
    wrap.param_specs = (
        flat_buffer_specs(layout.num_buffers, data_axes(mesh) if mesh else ())
        if params_impl == "flat" else (tree_specs if grid is not None else None))
    wrap.grid = grid
    return wrap


# -------------------------------------------------------- ACCUM-NORM ----

def _accumulate_spanning(loss_fn, params, batch, grid, add):
    """ACCUM-NORM's microbatch loop over J data ranks: each microbatch spans
    every worker (each holds its slice of it).  Per microbatch the rank's
    gradient g_jm, weighted by its VALID-TOKEN count w_j, goes to `add(grads,
    w_j)`, which sums w_j·g_jm over the workers (and the model group where
    needed) into the step's accumulator and returns ‖Σ_j w_j·g_jm‖², every
    leaf counted once; with W_m = Σ_j w_j that is W_m²‖ĝ^m‖², ĝ^m the
    microbatch's gradient.  Returns (loss, aux, Σ_m‖ĝ^m‖², m_eff,
    max(Σ_m W_m, 1)) as 0-d tensors, equal on every rank; the caller
    divides the accumulator by the last."""
    leaves, treedef = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten(treedef, xs)
    device = xs[0].device
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    acc_loss, acc_aux, acc_sq, acc_w, acc_m = (zero() for _ in range(5))
    for i in range(batch["tokens"].shape[0]):
        mb = {k: v[i] for k, v in batch.items()}
        with grid.rules_on():
            with span("step.forward"):
                loss, metrics = loss_fn(tree, mb)
            with span("step.backward"):
                grads = torch.autograd.grad(loss, xs)
        with span("step.accumulate"), torch.no_grad():
            w = (mb["labels"] >= 0).sum().float()
            w_m = psum(w.clone(), grid.dg)
            sq = add(grads, w)
            acc_sq += torch.where(w_m > 0, sq / torch.clamp(w_m * w_m, min=1.0),
                                  0.0)
            acc_loss += w * loss.detach()
            acc_aux += w * metrics["aux"].detach()
            acc_w += w_m
            acc_m += (w_m > 0).float()
    denom = torch.clamp(acc_w, min=1.0)
    with span("step.metrics"):
        loss, aux = psum(torch.stack([acc_loss, acc_aux]), grid.dg) / denom
    return loss, aux, acc_sq, acc_m, denom


def _accum_grid_step(model, opt_cfg, grid, rest_specs, layout, stats_impl,
                     params_impl, device):
    """ACCUM-NORM on a grid (J data ranks, a model axis, or both), in any
    residency (module docstring)."""
    bufs = {}

    @_in_step_span
    def step(params, opt_state, batch, lr):
        batch = worker_batch(batch, grid.idx, grid.J)
        if layout is not None and not bufs:
            bufs["acc"] = layout.zeros(torch.float32, device)
            bufs["g_m"] = layout.zeros(torch.float32, device)
            bufs["full"] = ([torch.empty(n, dtype=dt, device=device)
                             for n, dt in zip(layout.buffer_sizes,
                                              layout.buffer_dtypes)]
                            if grid.J > 1 and params_impl == "flat" else None)
        with span("step.gather_params"):
            if params_impl == "flat":
                full = layout.unflatten(gather_flat_buffers(
                    params, bufs["full"], grid.mesh))
                tree = grid.local(full)
            else:
                # ZeRO-3: this rank's slices gathered over the data workers
                tree = gather_tree(params, rest_specs, grid.mesh,
                                   axes=grid.daxes)
        if layout is not None:
            # born flat: each microbatch's gradient made whole in g_m
            acc, g_m = bufs["acc"], bufs["g_m"]
            for b in acc:
                b.zero_()

            def add(grads, w):
                views = grid.born_flat(g_m, layout)
                for v, g in zip(views, grads):
                    v.copy_(g).mul_(w)
                grid.drop_copies(g_m, layout)
                sq = torch.zeros((), dtype=torch.float32, device=device)
                for a, b in zip(acc, g_m):
                    psum(b)                   # every rank: data x model
                    a.add_(b)
                    sq += torch.sum(torch.square(b))
                return sq
        else:
            acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                   for x in tree_leaves(tree)]

            def add(grads, w):
                parts = [g.float() * w for g in grads]
                grid.sum_partial(parts)
                for a, x in zip(acc, parts):
                    a.add_(psum(x, grid.dg))
                return psum(tree_sqnorm(grid.once(parts)), grid.mg)

        loss, aux, sq_sum, m_eff, denom = _accumulate_spanning(
            model.loss, tree, batch, grid, add)
        for a in acc:
            a.div_(denom)
        if stats_impl == "flat":
            # the worker's shard of the mean gradient; Σg² over the shards
            g_local = [shard_bucket(b, grid.idx, grid.J) for b in acc]
            with span("step.statistic"):
                gsq = torch.zeros((), dtype=torch.float32, device=device)
                for b in g_local:
                    gsq += torch.sum(torch.square(b))
                gsq = psum(gsq, grid.dg)
            with span("step.tail"):
                pb_local = (list(params) if params_impl == "flat" else
                            [shard_bucket(b, grid.idx, grid.J)
                             for b in layout.flatten(gather_tree(
                                 params, rest_specs, grid.mesh))])
                _, new_mb, new_vb, count, gnorm, _ = adamw_update_buffers(
                    pb_local, g_local, list(opt_state["m"]),
                    list(opt_state["v"]), opt_cfg, lr, opt_state["count"],
                    grad_sqnorm=gsq)
                new_opt = {"m": tuple(new_mb), "v": tuple(new_vb),
                           "count": count}
                # tree params: the rank keeps its slices of the updated params
                new_params = (tuple(params) if params_impl == "flat" else
                              _contiguous_copy(shard_tree(layout.unflatten(
                                  gather_flat_buffers(pb_local, mesh=grid.mesh)),
                                  rest_specs, grid.mesh)))
            with span("step.statistic"):
                var_l1, gsq = accum_variance_stats(sq_sum, None, m_eff, grid.J,
                                                   gsq=gsq)
        elif params_impl == "flat":
            # the tree oracle on the whole views, with whole moment trees;
            # the worker keeps its shard of the packed result
            g = layout.unflatten(acc)
            with span("step.statistic"):
                var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, grid.J)
            with span("step.tail"):
                with torch.no_grad():
                    new_tree, new_opt, gnorm = adamw_update(
                        full, g, opt_state, opt_cfg, lr)
                new_params = tuple(shard_flat_buffers(layout.flatten(new_tree),
                                                      grid.mesh))
        else:
            with span("step.statistic"):
                gsq = psum(tree_sqnorm(grid.once(acc)), grid.mg)
            with span("step.tail"):
                g = tree_unflatten(tree_flatten(params)[1], acc)
                g_local = _contiguous_copy(shard_tree(g, rest_specs, grid.mesh,
                                                      axes=grid.daxes))
                with torch.no_grad():
                    new_params, new_opt, gnorm = adamw_update(
                        params, g_local, opt_state, opt_cfg, lr,
                        grad_sqnorm=gsq)
            with span("step.statistic"):
                var_l1, gsq = accum_variance_stats(sq_sum, None, m_eff, grid.J,
                                                   gsq=gsq)
        with span("step.metrics"):
            metrics = {"loss": loss, "aux": aux, "var_l1": var_l1,
                       "grad_sqnorm": gsq, "grad_norm": gnorm,
                       "clip_scale": clip_scale_from_norm(gnorm,
                                                          opt_cfg.grad_clip)}
        return new_params, new_opt, metrics

    return step


def make_accum_norm_step(model, opt_cfg: AdamWConfig, *,
                         stats_impl: str = "tree", params_impl: str = "tree",
                         params_like=None, device=None, mesh=None,
                         bucket_bytes=None):
    """Build the ACCUM-NORM step.  Returns `wrap`, with `wrap(batch_like)`
    -> `step(params, opt_state, batch, lr) -> (params, opt_state, metrics)`
    (one eager step serves every batch shape), `wrap.flat_layout` the
    step's shared `FlatLayout` (None on the tree path), and
    `wrap.param_specs` and `wrap.grid` as in `make_fsdp_norm_step`.

    Flat params are the tuple of bucket buffers (on a mesh of J data
    workers, this rank's 1/J shards of them); flat stats take `opt_state`
    from `init_adamw_flat(layout=wrap.flat_layout)`.  Flat/flat updates
    both in place and returns them.  Tree params are whole trees, on a mesh
    this rank's `param_pspecs(fsdp=True)` slices (`params.shard_tree`).
    `batch` holds tensors on the params' device (`batch_to_device`), the
    GLOBAL batch on a mesh; `lr` is a float or 0-d tensor.  Metrics are 0-d
    f32 tensors on the device, equal on every rank.  Without `params_like`
    (the whole tree) the step is built from `model.init(0, device)`: on the
    CUDA card unless `device` names another, and it raises without one.
    `bucket_bytes` as in `make_fsdp_norm_step`."""
    _check_impls(stats_impl, params_impl)
    if params_like is None:
        params_like = model.init(0, device)
    if device is None:
        device = tree_flatten(params_like)[0][0].device
    device = torch.device(device)
    # tree params rest ZeRO-3 (fsdp=True); flat buffers are sharded over
    # the data workers and the forward's TP views follow FSDP-Norm's specs
    grid = _tp_grid(mesh, params_like, fsdp=params_impl == "tree",
                    manual=False)
    J = 1 if grid is None else grid[0].J
    layout = (FlatLayout.from_tree(params_like, bucket_bytes, shard_divisor=J,
                                   device=device)
              if "flat" in (stats_impl, params_impl) else None)

    def wrap(batch_like=None):
        return step

    wrap.flat_layout = layout
    wrap.mesh = mesh
    if grid is not None:
        grid, rest_specs = grid
        step = _accum_grid_step(model, opt_cfg, grid, rest_specs, layout,
                                stats_impl, params_impl, device)
        wrap.param_specs = (flat_buffer_specs(layout.num_buffers, grid.daxes)
                            if params_impl == "flat" else rest_specs)
        wrap.grid = grid
        return wrap
    wrap.param_specs, wrap.grid = None, None
    grad_bufs = []             # persistent f32 gradient buffers (flat params)

    @_in_step_span
    def step(params, opt_state, batch, lr):
        if params_impl == "flat":
            if not grad_bufs:
                grad_bufs.extend(layout.zeros(torch.float32, device))
            for b in grad_bufs:
                b.zero_()
            pb = list(params)
            tree = layout.unflatten(pb)
            acc = tree_flatten(layout.unflatten(grad_bufs))[0]
            loss, aux, sq_sum, m_eff, _ = _accumulate(
                model.loss, tree, batch, True, acc)
            if stats_impl == "flat":
                with span("step.tail"):
                    _, new_mb, new_vb, count, gnorm, gsq = adamw_update_buffers(
                        pb, grad_bufs, list(opt_state["m"]),
                        list(opt_state["v"]), opt_cfg, lr, opt_state["count"])
                new_params = tuple(pb)
                new_opt = {"m": tuple(new_mb), "v": tuple(new_vb),
                           "count": count}
                with span("step.statistic"):
                    var_l1, gsq = accum_variance_stats(sq_sum, None, m_eff, J,
                                                       gsq=gsq)
            else:
                # tree-oracle tail on the views, packed back once
                g = layout.unflatten(grad_bufs)
                with span("step.statistic"):
                    var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J)
                with span("step.tail"):
                    with torch.no_grad():
                        new_tree, new_opt, gnorm = adamw_update(
                            tree, g, opt_state, opt_cfg, lr)
                    new_params = tuple(layout.flatten(new_tree))
        else:
            leaves, treedef = tree_flatten(params)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss, aux, sq_sum, m_eff, _ = _accumulate(
                model.loss, params, batch, True, acc)
            g = tree_unflatten(treedef, acc)
            if stats_impl == "flat":
                # pack g and the params once; the fused tail updates the
                # packed params, whose views are the new tree
                with span("step.tail"):
                    pb = layout.flatten(params)
                    _, new_mb, new_vb, count, gnorm, gsq = adamw_update_buffers(
                        pb, layout.flatten(g), list(opt_state["m"]),
                        list(opt_state["v"]), opt_cfg, lr, opt_state["count"])
                    new_params = layout.unflatten(pb)
                new_opt = {"m": tuple(new_mb), "v": tuple(new_vb),
                           "count": count}
                with span("step.statistic"):
                    var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J,
                                                       gsq=gsq)
            else:
                with span("step.statistic"):
                    var_l1, gsq = accum_variance_stats(sq_sum, g, m_eff, J)
                with span("step.tail"), torch.no_grad():
                    new_params, new_opt, gnorm = adamw_update(
                        params, g, opt_state, opt_cfg, lr)
        with span("step.metrics"):
            metrics = {"loss": loss, "aux": aux, "var_l1": var_l1,
                       "grad_sqnorm": gsq, "grad_norm": gnorm,
                       "clip_scale": clip_scale_from_norm(gnorm,
                                                          opt_cfg.grad_clip)}
        return new_params, new_opt, metrics

    return wrap
