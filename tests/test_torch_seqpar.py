"""Sequence parallelism on the CPU: the residual stream's sequence split
over the model axis between TP regions (`distributed/sharding.py`), the
port's counterpart of the reference's `act_seq` rule.

* The pieces on 2 gloo ranks: `stream_exit` (reduce-scatter forward,
  all-gather backward), `stream_enter` (all-gather forward,
  reduce-scatter backward), `stream_gather` and `stream_scatter` against
  the whole tensors, forward and every gradient, at seq 16 and at seq 15
  (a length the axis does not divide: zero-padded, the pad trimmed).
* Each layer kind's `block_full` on a (1, 2) mesh under sequence
  parallelism against the whole block in one process: attention with GQA,
  with kv heads replicated, with a window, softcap and gemma2's
  post-norms, at seq 16 and 15; MLA, MLA with MoE, dbrx's MoE, SSD and
  RG-LRU.  Output, dx and every leaf's gradient to 1e-5 of the whole
  block's, relative to each tensor's largest magnitude, a "partial"
  leaf's gradient summed over the model group first.  Whole models the
  same way: whisper's encoder and cross-attention, internvl2's vision
  prefix, gemma2 and llama3.2-1b at seq 15 (the loss and every gradient).
* Norms: every leaf of a norm on the residual stream is "partial" under
  sequence parallelism, and its summed gradient equals the whole run's.
* `tp_boundary`: gradients equal to remat="none" to 1e-6 under sequence
  parallelism, and its forward reduce-scatters run once.
* `make_fsdp_norm_step(sequence_parallel=True)` on 2 × 2 against the
  reference's `sequence_parallel=True` on 4 forced host devices: flat/flat
  for llama3.2-1b, deepseek-v2 (MLA + MoE), mamba2 (SSD) and
  recurrentgemma (RG-LRU); tree/tree for llama3.2-1b; a mixed residency
  (dbrx, stats flat with params tree); llama3.2-1b at seq 15.  On 1 × 2
  (llama3.2-1b flat/flat at seq 15, deepseek-v2 tree/tree) against the
  reference's step on one device (`_ref_grid`).  Metrics at rtol 1e-5,
  parameters by `tests/test_torch_mesh.py`'s per-entry share.

The reference's two parts run as processes of their own beside each
other and beside the port's ranks."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from conftest import SRC
from test_torch_helpers import jax_tree_np

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed import params as tparams
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, TP_STATS, gather_flat_buffers, reset_tp_stats,
    shard_flat_buffers, stream_enter, stream_exit, stream_gather,
    stream_length, stream_scatter, use_sharding_rules, with_sequence_parallel)
from repro_torch.distributed.train_step import batch_to_device, make_fsdp_norm_step
from repro_torch.launch import mesh as tmesh
from repro_torch.models import blocks as blk
from repro_torch.models.config import ATTN, LOCAL_ATTN, MLA_ATTN, RGLRU, SSD
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_paths, tree_unflatten

TIMEOUT_S = 300
TOL = 1e-5
SP_RULES = with_sequence_parallel(DEFAULT_RULES)
PIECES = [f"{p}-{t}" for p in ("exit", "enter", "gather", "scatter") for t in (16, 15)]
# name: (arch, layer kind, moe layer, seq, config changes)
BLOCKS = {
    "attn-gqa": ("llama3.2-1b", ATTN, False, 16, {}),
    "attn-gqa-seq15": ("llama3.2-1b", ATTN, False, 15, {}),
    "attn-kv-replicated": ("llama3.2-1b", ATTN, False, 16, dict(num_kv_heads=1)),
    "attn-window-softcap-postnorm": ("gemma2-27b", LOCAL_ATTN, False, 16, {}),
    "mla": ("deepseek-v2-236b", MLA_ATTN, False, 16, {}),
    "mla-moe": ("deepseek-v2-236b", MLA_ATTN, True, 16, {}),
    "moe-dbrx": ("dbrx-132b", ATTN, True, 15, {}),
    "ssd": ("mamba2-370m", SSD, False, 16, {}),
    "rglru": ("recurrentgemma-9b", RGLRU, False, 15, {}),
}
# name: (arch, seq)
MODELS = {"whisper-encdec": ("whisper-base", 16), "internvl2-prefix": ("internvl2-1b", 8),
          "gemma2": ("gemma2-27b", 16), "llama-seq15": ("llama3.2-1b", 15)}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(shape, seed, scale=1.0):
    return scale * torch.randn(shape, generator=_gen(seed))


def _rows(x, m, size):
    """Rank m's slice of the stream x (dim 1), zero-padded as the port
    pads it: c = ceil(t / size) rows."""
    c = -(-x.shape[1] // size)
    pad = torch.zeros((x.shape[0], size * c - x.shape[1]) + x.shape[2:], dtype=x.dtype)
    return torch.cat([x, pad], 1)[:, m * c:(m + 1) * c]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# -------------------------------------------------------------- pieces ----

def _pieces(mesh):
    """{piece: max relative error} of the four stream functions on this
    rank: forward and the input's gradient against whole tensors built
    from every rank's seeded parts."""
    m, size = mesh.model_index, mesh.model_size
    out = {}
    for t in (16, 15):
        b, d = 2, 6
        whole = _randn((b, t, d), 1)
        parts = [_randn((b, t, d), 10 + r) for r in range(size)]   # per-rank partials
        ups = [_randn((b, t, d), 20 + r) for r in range(size)]     # per-rank upstreams
        up = _randn((b, t, d), 30)                                 # one upstream
        with use_sharding_rules(SP_RULES, mesh), stream_length(t):
            # exit: rank m's slice of Σ partials; the partial's gradient is
            # the whole upstream
            p = parts[m].clone().requires_grad_(True)
            y = stream_exit(p)
            (g,) = torch.autograd.grad((y * _rows(up, m, size)).sum(), p)
            out[f"exit-{t}"] = max(_rel(y, _rows(sum(parts), m, size)), _rel(g, up))
            # enter: the whole from the slices; the slice's gradient is its
            # slice of Σ upstreams
            x = _rows(whole, m, size).clone().requires_grad_(True)
            y = stream_enter(x)
            (g,) = torch.autograd.grad((y * ups[m]).sum(), x)
            out[f"enter-{t}"] = max(_rel(y, whole), _rel(g, _rows(sum(ups), m, size)))
            # gather: the whole from the slices; the gradient (the same on
            # every rank) is cut to the slice
            x = _rows(whole, m, size).clone().requires_grad_(True)
            y = stream_gather(x)
            (g,) = torch.autograd.grad((y * up).sum(), x)
            out[f"gather-{t}"] = max(_rel(y, whole), _rel(g, _rows(up, m, size)))
            # scatter: the slice of a tensor every rank holds; the gradient
            # is every slice's
            x = whole.clone().requires_grad_(True)
            y = stream_scatter(x)
            (g,) = torch.autograd.grad((y * _rows(up, m, size)).sum(), x)
            out[f"scatter-{t}"] = max(_rel(y, _rows(whole, m, size)), _rel(g, up))
    return out


# --------------------------------------------------------- blocks, models ----

def _compare_sp(fn, params, x, mesh, seed):
    """`fn(tree, x)` -> (stream out, scalar extra) under sequence
    parallelism on this rank (x and out its slices) against one process
    (whole): the largest relative error of the output, dx and every leaf's
    gradient (a "partial" leaf's summed over the model group), and the
    count of leaves off "replicated"."""
    m, size = mesh.model_index, mesh.model_size
    specs = tparams.param_pspecs(params, mesh)
    roles = tree_flatten(tparams.model_roles(params, specs, sequence_parallel=True))[0]
    up = None

    def run(tree, sp):
        nonlocal up
        leaves, treedef = tree_flatten(tree)
        ps = [p.detach().clone().requires_grad_(True) for p in leaves]
        xin = (_rows(x, m, size) if sp else x).detach().clone().requires_grad_(True)
        with use_sharding_rules(SP_RULES if sp else None, mesh):
            out, extra = fn(tree_unflatten(treedef, ps), xin)
            if up is None:
                up = _randn(out.shape, seed)
            u = _rows(up, m, size) if sp else up
            grads = torch.autograd.grad((out * u).sum() + extra, ps + [xin])
        return out.detach(), grads[:-1], grads[-1]

    out_w, gp_w, gx_w = run(params, False)
    local = tree_map(lambda v: v.contiguous(), tparams.shard_tree(params, specs, mesh))
    out_s, gp_s, gx_s = run(local, True)
    n = min(out_s.shape[1], x.shape[1] - m * out_s.shape[1])     # rows of the slice that are real
    err = max(_rel(out_s[:, :n], _rows(out_w, m, size)[:, :n]),
              _rel(gx_s[:, :n], _rows(gx_w, m, size)[:, :n]))
    want = tree_leaves(tparams.shard_tree(tree_unflatten(tree_flatten(params)[1],
                                                         list(gp_w)), specs, mesh))
    for g, w, role in zip(gp_s, want, roles):
        if role == "partial":
            g = tmesh.psum(g.clone(), mesh.model_group)
        err = max(err, _rel(g, w))
    return err, sum(r != "replicated" for r in roles)


def _blocks(mesh):
    out = {}
    for i, (name, (arch, kind, moe_layer, t, change)) in enumerate(BLOCKS.items()):
        cfg = dataclasses.replace(get_smoke_config(arch), **change)
        p = blk.init_block(_gen(100 + i), cfg, kind, moe_layer, "cpu")
        # activations of order 1 from the 0.02 init; non-zero norm biases
        p = tree_map(lambda w: w * 10 if w.dim() >= 2 else w + 0.1 * torch.randn(
            w.shape, generator=_gen(200 + i), dtype=w.dtype), p)
        b = 2
        x = _randn((b, t, cfg.d_model), 300 + i, 0.5)
        pos = torch.arange(t).expand(b, t)

        def fn(tr, xs, cfg=cfg, kind=kind, moe_layer=moe_layer, pos=pos):
            y, aux, _ = blk.block_full(tr["layers"][0], xs, pos, cfg, kind, moe_layer)
            return y, 100 * aux                          # the aux loss's gradient too
        out[name] = _compare_sp(fn, {"layers": [p]}, x, mesh, 400 + i)
    return out


def _batch(cfg, t, seed):
    g = _gen(seed)
    b = 2
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (b, t), generator=g)}
    batch["labels"][0, -3:] = -1                       # masked labels
    if cfg.frontend.kind == "vision_stub":
        batch["patch_embeds"] = torch.randn((b, cfg.frontend.num_prefix_tokens,
                                             cfg.d_model), generator=g)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn((b, cfg.encoder.num_frames, cfg.d_model),
                                      generator=g)
    return batch


def _model_grads(cfg, params, batch, mesh, sp):
    model = build_model(cfg)
    leaves, treedef = tree_flatten(params)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    with use_sharding_rules(SP_RULES if sp else None, mesh):
        loss, _ = model.loss(tree_unflatten(treedef, ps), batch)
        grads = torch.autograd.grad(loss, ps)
    return loss.detach(), list(grads)


def _models(mesh):
    """{name: (max relative error of the loss and every leaf's gradient,
    norm leaves checked, {norm key: relative error}) } of whole models."""
    out = {}
    for i, (name, (arch, t)) in enumerate(MODELS.items()):
        cfg = get_smoke_config(arch)
        params = build_model(cfg).init(0, device="cpu")
        specs = tparams.param_pspecs(params, mesh)
        roles = tree_flatten(tparams.model_roles(params, specs, sequence_parallel=True))[0]
        keys = [k for k, _ in tree_paths(params)]
        batch = _batch(cfg, t, 500 + i)
        loss_w, g_w = _model_grads(cfg, params, batch, mesh, False)
        local = tree_map(lambda v: v.contiguous(), tparams.shard_tree(params, specs, mesh))
        loss_s, g_s = _model_grads(cfg, local, batch, mesh, True)
        want = tree_leaves(tparams.shard_tree(tree_unflatten(tree_flatten(params)[1], g_w),
                                              specs, mesh))
        err, norms = _rel(loss_s, loss_w), {}
        for key, g, w, role in zip(keys, g_s, want, roles):
            if role == "partial":
                g = tmesh.psum(g.clone(), mesh.model_group)
            e = _rel(g, w)
            err = max(err, e)
            if tparams.STREAM_NORMS.intersection(key.split("/")):
                norms[key] = (role, e)
        out[name] = (err, norms)
    return out


def _remat(mesh):
    """llama3.2-1b smoke's gradients under sequence parallelism with
    remat="tp_boundary" and "none", and the reduce-scatters of each: the
    largest relative difference and the two counts."""
    base = get_smoke_config("llama3.2-1b")
    params = build_model(base).init(0, device="cpu")
    specs = tparams.param_pspecs(params, mesh)
    local = tree_map(lambda v: v.contiguous(), tparams.shard_tree(params, specs, mesh))
    batch = _batch(base, 16, 600)
    res = {}
    for remat in ("none", "tp_boundary"):
        reset_tp_stats()
        res[remat] = (_model_grads(dataclasses.replace(base, remat=remat), local, batch,
                                   mesh, True)[1], TP_STATS["seq_reduce_scatter"])
    err = max(_rel(a, b) for a, b in zip(res["tp_boundary"][0], res["none"][0]))
    return err, res["none"][1], res["tp_boundary"][1]


def _rank_all():
    torch.manual_seed(0)
    mesh = tmesh.make_host_mesh(data=1, model=2)
    return {"pieces": _pieces(mesh), "blocks": _blocks(mesh), "models": _models(mesh),
            "remat": _remat(mesh)}


@pytest.fixture(scope="module")
def ranks():
    return tmesh.spawn_workers(_rank_all, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("piece", PIECES)
def test_stream_piece_matches_whole(ranks, piece):
    assert ranks["pieces"][piece] <= 1e-6, (piece, ranks["pieces"][piece])


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_under_sequence_parallelism_matches_whole(ranks, name):
    err, off_replicated = ranks["blocks"][name]
    assert err <= TOL, (name, err)
    assert off_replicated > 0, name          # the block really ran on a model axis


@pytest.mark.parametrize("name", list(MODELS))
def test_model_under_sequence_parallelism_matches_whole(ranks, name):
    err, norms = ranks["models"][name]
    assert err <= TOL, (name, err)
    assert norms


def test_stream_norms_are_partial_and_sum_to_whole(ranks):
    """Every norm leaf on the residual stream (pre, post, MLP, post-MLP,
    cross-attention, the decoder's and the encoder's final norms) is
    "partial", and its gradient summed over the model group equals the
    whole run's."""
    seen = set()
    for name, (_, norms) in ranks["models"].items():
        for key, (role, err) in norms.items():
            assert role == "partial", (name, key)
            assert err <= TOL, (name, key, err)
            seen.update(p for p in key.split("/") if p in tparams.STREAM_NORMS)
            if key.startswith("encoder/"):
                seen.add("encoder")
    assert seen == set(tparams.STREAM_NORMS) | {"encoder"}, seen


def test_tp_boundary_under_sequence_parallelism(ranks):
    """remat="tp_boundary" keeps each exit's reduce-scattered slice: its
    gradients equal remat="none"'s to 1e-6, and it runs no reduce-scatter
    more (the backward's come from the entries, as without remat)."""
    err, none, kept = ranks["remat"]
    assert err <= 1e-6, err
    assert kept == none > 0, (kept, none)


# ------------------------------------------------------ the reference ----

STEPS = 3
SNAPS = (0, STEPS - 1)
SHARES = (5e-4, 2.5e-2)
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")
LR = 1e-3
# (arch, stats_impl, params_impl, (data, model), seq)
CASES = [("llama3.2-1b", "flat", "flat", (2, 2), 16),
         ("deepseek-v2-236b", "flat", "flat", (2, 2), 16),
         ("mamba2-370m", "flat", "flat", (2, 2), 16),
         ("recurrentgemma-9b", "flat", "flat", (2, 2), 16),
         ("llama3.2-1b", "tree", "tree", (2, 2), 16),
         ("dbrx-132b", "flat", "tree", (2, 2), 16),
         ("llama3.2-1b", "flat", "flat", (2, 2), 15),
         ("llama3.2-1b", "flat", "flat", (1, 2), 15),
         ("deepseek-v2-236b", "tree", "tree", (1, 2), 16)]


def _ref_grid(d, m):
    """The reference's grid for the port's (d, m): the same, but (1, 1)
    for one data worker, where the reference's FSDP-Norm on a model axis
    fails to compile with this container's jax (ROADMAP §3); there its
    whole-sequence step computes what sequence parallelism must, and the
    port's 1 × 2 is held to it."""
    return (d, m) if d > 1 else (1, 1)


def _tag(case):
    arch, stats, pimpl, (d, m), seq = case
    return f"{arch}/{stats}-{pimpl}/{d}x{m}/seq{seq}"


def _plan(d):
    return BatchPlan(global_batch=4 * d, micro_batch=2, accum_steps=2, workers=d)


_JAX = """
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.core.schedule import BatchPlan
from repro.data.pipeline import MarkovTokens, make_batch
from repro.distributed.train_step import make_fsdp_norm_step
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat

out = {}
for arch, stats, pimpl, (d, m), seq, (rd, rm) in %(cases)r:
    plan = BatchPlan(global_batch=4 * d, micro_batch=2, accum_steps=2, workers=d)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    mesh = make_host_mesh(data=rd, model=rm)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    batches = [jax.tree.map(jnp.asarray, make_batch(src, t, plan, seq))
               for t in range(%(steps)d)]
    params = model.init(jax.random.PRNGKey(0))
    wrap, _, _ = make_fsdp_norm_step(model, AdamWConfig(), mesh, stats_impl=stats,
                                     params_impl=pimpl, params_like=params,
                                     sequence_parallel=True)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, shard_divisor=d, layout=layout)
           if stats == "flat" else init_adamw(params))
    if pimpl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if pimpl == "flat"
            else (lambda p: p))
    tag = f"{arch}/{stats}-{pimpl}/{d}x{m}/seq{seq}"
    with set_mesh(mesh):
        fn = wrap(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                               batches[0]))
        for t, b in enumerate(batches):
            params, opt, mt = fn(params, opt, b, jnp.float32(%(lr)r))
            for k in %(metrics)r:
                out[f"{tag}/{k}/{t}"] = np.float64(mt[k])
            if t in %(snaps)r:
                for i, leaf in enumerate(jax.tree.leaves(view(params))):
                    out[f"{tag}/snap{t}/{i}"] = np.asarray(leaf, np.float32)
np.savez(%(path)r, **out)
print("SAVED")
"""


def _start_reference(code: str):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's steps in two processes, started at once; a callable
    that waits for both."""
    root = tmp_path_factory.mktemp("ref")
    procs = []
    for i, part in enumerate((CASES[::2], CASES[1::2])):
        path = str(root / f"ref{i}.npz")
        procs.append((_start_reference(_JAX % dict(
            cases=[c + (_ref_grid(*c[3]),) for c in part], steps=STEPS, lr=LR, metrics=METRICS, snaps=SNAPS,
            path=path)), path))

    def wait():
        out = {}
        for proc, path in procs:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S * 2)
            if proc.returncode != 0 or "SAVED" not in stdout:
                raise AssertionError(f"reference process failed:\n{stdout}\n{stderr}")
            out.update(np.load(path))
        return out

    yield wait
    for proc, _ in procs:
        proc.kill()
        proc.communicate()


def _steps_rank(cases, inits, batches):
    """This rank's sequence-parallel FSDP-Norm steps for every case on its
    grid (the ranks of the process group are the grid): rank 0's metrics
    and whole parameters, and the reduce-scatters it ran."""
    out = {}
    world = torch.distributed.get_world_size()
    for case, init_np in zip(cases, inits):
        arch, stats, pimpl, (d, m), seq = case
        if d * m != world:
            continue
        mesh = tmesh.make_host_mesh(data=d, model=m)
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = params_from_jax(init_np, cfg)
        wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl=stats,
                                   params_impl=pimpl, sequence_parallel=True,
                                   params_like=params, mesh=mesh)
        layout, specs = wrap.flat_layout, wrap.param_specs
        if pimpl == "tree":
            params = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                              tparams.shard_tree(params, specs, mesh))
        opt = (init_adamw_flat(params, shard_divisor=d, layout=layout)
               if stats == "flat" else init_adamw(params))
        if pimpl == "flat":
            params = tuple(shard_flat_buffers(layout.flatten(params), mesh))
        reset_tp_stats()
        for t, b in enumerate(batches[_tag(case)]):
            params, opt, mt = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                      torch.tensor(LR))
            for k in METRICS:
                out[f"{_tag(case)}/{k}/{t}"] = float(mt[k])
            if t in SNAPS:
                full = (layout.unflatten(gather_flat_buffers(params, mesh=mesh))
                        if pimpl == "flat" else tparams.gather_tree(params, specs, mesh))
                out[f"{_tag(case)}/snap{t}"] = [x.detach().clone() for x in tree_leaves(full)]
        out[f"{_tag(case)}/reduce_scatters"] = TP_STATS["seq_reduce_scatter"]
    return out


@pytest.fixture(scope="module")
def port_steps():
    inits = [jax_tree_np(jbuild(jget(c[0])).init(jax.random.PRNGKey(0))) for c in CASES]
    batches = {_tag(c): [make_batch(MarkovTokens(vocab_size=get_smoke_config(c[0]).vocab_size,
                                                 seed=0), t, _plan(c[3][0]), c[4])
                         for t in range(STEPS)] for c in CASES}
    out = {}
    for world in (4, 2):
        out.update(tmesh.spawn_workers(_steps_rank, world, CASES, inits, batches,
                                       timeout_s=TIMEOUT_S))
    return out, inits


@pytest.mark.parametrize("case", CASES, ids=lambda c: _tag(c).replace("/", "-"))
def test_sequence_parallel_step_matches_reference(reference, port_steps, case):
    got, inits = port_steps
    want = reference()
    tag = _tag(case)
    for t in range(STEPS):
        for k in METRICS:
            np.testing.assert_allclose(got[f"{tag}/{k}/{t}"], want[f"{tag}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7, err_msg=f"{tag} step {t} {k}")
    assert got[f"{tag}/var_l1/0"] > 0 or case[3][0] == 1   # one worker: no variance
    assert got[f"{tag}/reduce_scatters"] > 0                # the stream was split
    treedef = jax.tree.structure(inits[CASES.index(case)])
    cfg = get_smoke_config(case[0])
    for t, share in zip(SNAPS, SHARES):
        leaves = [want[f"{tag}/snap{t}/{i}"] for i in range(treedef.num_leaves)]
        want_tree = params_from_jax(jax.tree.unflatten(treedef, leaves), cfg)
        w = np.concatenate([x.numpy().ravel() for x in tree_leaves(want_tree)])
        have = np.concatenate([g.float().numpy().ravel() for g in got[f"{tag}/snap{t}"]])
        np.testing.assert_allclose(have, w, rtol=0, atol=1e-4,
                                   err_msg=f"{tag} after step {t + 1}")
        off = np.abs(have - w) > 1e-7 + 1e-5 * np.abs(w)
        assert off.mean() <= share, (tag, t + 1, off.mean())
