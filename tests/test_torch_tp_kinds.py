"""Tensor parallelism of the MoE, MLA, SSD and RG-LRU layers and the mixed
residencies on a grid, on the CPU.

* Layer pieces on 2 gloo ranks against the whole layer in one process
  (as `tests/test_torch_tp.py` holds attention and the MLPs): dbrx's and
  deepseek-v2's MoE (shared experts sharded, and whole beside sharded
  experts), MLA (with and without a query LoRA, and its chunked path),
  mamba2's SSD mixer and recurrentgemma's RG-LRU block.  Output, dx and
  every leaf's gradient to 1e-5 of the whole layer's, relative to the
  largest magnitude of each, a "partial" leaf's gradient summed over the
  model group first, so each leaf's `model_roles` role is the one its
  gradient shows.
* Both steps of dbrx, deepseek-v2, mamba2 and recurrentgemma smoke on a
  2 × 2 grid of gloo ranks (J = 2 data workers by a model axis of 2)
  against the reference on 4 forced host devices, flat/flat, and both
  mixed residencies (stats flat with params tree, stats tree with params
  flat; FSDP-Norm on recurrentgemma, ACCUM-NORM on deepseek-v2): metrics
  at rtol 1e-5, parameters by `tests/test_torch_mesh.py`'s per-entry
  share.  Unpadded batches (ROADMAP §3); MoE at capacity factor 2 with
  top-2 of 4 experts, where no pair drops.
* `run_training` of the four configs, tree/tree, with FSDP-Norm on 2 × 2
  and with ACCUM-NORM on 1 × 2: the reference's batch trajectory exactly,
  its losses, var_l1 and grad_sqnorm to rtol 1e-5.

The reference's four parts (two of grid steps, two of loops) run as
processes of their own beside each other and beside the port's ranks."""

import dataclasses
import json
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
    DEFAULT_RULES, gather_flat_buffers, shard_flat_buffers, use_sharding_rules)
from repro_torch.distributed.train_step import (
    batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

TIMEOUT_S = 300
TOL = 1e-5
PIECES = ("moe-dbrx", "moe-deepseek-shared", "moe-shared-whole", "mla",
          "mla-no-q-lora", "mla-chunked", "ssd", "rglru")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _scaled(tree, scale):
    """The matrices of `tree` times `scale` (activations of order 1 with
    the 0.02 init); vectors as they are."""
    return tree_map(lambda w: w * scale if w.dim() >= 2 else w, tree)


def _compare(fn, params, inputs, mesh, seed):
    """The largest relative error of `fn(params, *inputs)` and of every
    gradient (inputs and leaves), TP against whole, on this rank, each
    tensor's max abs error over its largest magnitude; and the count of
    leaves on the model axis."""
    specs = tparams.param_pspecs(params, mesh)
    roles = tree_flatten(tparams.model_roles(params, specs))[0]

    def run(tree, tp):
        leaves, treedef = tree_flatten(tree)
        xs = [p.detach().clone().requires_grad_(True) for p in leaves]
        ins = [x.detach().clone().requires_grad_(True) for x in inputs]
        with use_sharding_rules(DEFAULT_RULES if tp else None, mesh):
            out = fn(tree_unflatten(treedef, xs), *ins)
            up = torch.randn(out.shape, generator=_gen(seed))
            grads = torch.autograd.grad((out * up).sum(), xs + ins)
        return [out.detach()] + list(grads[len(xs):]), grads[:len(xs)]

    (whole, gp_w), (local, gp_t) = run(params, False), run(
        tree_map(lambda x: x.contiguous(), tparams.shard_tree(params, specs, mesh)), True)
    want = tree_leaves(tparams.shard_tree(tree_unflatten(tree_flatten(params)[1],
                                                         list(gp_w)), specs, mesh))
    pairs = list(zip(local, whole))
    for g, w, role in zip(gp_t, want, roles):
        if role == "partial":
            g = tmesh.psum(g.clone(), mesh.model_group)
        pairs.append((g, w))
    err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in pairs)
    return err, sum(r != "replicated" for r in roles)


def _rank_kinds():
    """Every piece on a (1, 2) mesh; returns {piece: (max error, leaves on
    the model axis)} of each rank."""
    torch.manual_seed(0)
    mesh = tmesh.make_host_mesh(data=1, model=2)
    out = {}
    b, t, d = 2, 8, 32
    x = 0.5 * torch.randn((b, t, d), generator=_gen(1))
    pos = torch.arange(t).expand(b, t)
    moe_cfgs = {"moe-dbrx": get_smoke_config("dbrx-132b").moe,
                "moe-deepseek-shared": get_smoke_config("deepseek-v2-236b").moe}
    moe_cfgs["moe-shared-whole"] = dataclasses.replace(
        moe_cfgs["moe-deepseek-shared"], shared_d_expert=33)                    # 33 columns: whole on 2 ranks
    for i, (name, m) in enumerate(moe_cfgs.items()):
        tree = {"layers": [{"mlp": _scaled(moe_lib.init_moe(_gen(10 + i), d, m,
                                                            torch.float32, "cpu"), 20)}]}

        def fn(tr, x, m=m):
            y, aux = moe_lib.moe_apply(tr["layers"][0]["mlp"], x, m)
            return y + 100 * aux               # the aux loss's gradient too
        out[name] = _compare(fn, tree, [x], mesh, 20 + i)
    mla_cfg = get_smoke_config("deepseek-v2-236b").mla
    for i, (name, m, chunk) in enumerate((
            ("mla", mla_cfg, None), ("mla-no-q-lora", dataclasses.replace(mla_cfg, q_lora_rank=0), None),
            ("mla-chunked", mla_cfg, 4))):
        tree = {"layers": [{"attn": _scaled(mla_lib.init_mla(_gen(30 + i), d, 4, m,
                                                             torch.float32, "cpu"), 20)}]}
        if chunk:
            mla_lib.CHUNK_THRESHOLD = t        # the query-chunked branch at t 8

        def fn(tr, x, m=m, chunk=chunk):
            return mla_lib.mla_full(tr["layers"][0]["attn"], x, pos, m, num_heads=4,
                                    q_chunk=chunk or mla_lib.Q_CHUNK)
        out[name] = _compare(fn, tree, [x], mesh, 40 + i)
        mla_lib.CHUNK_THRESHOLD = 2048
    ssm = get_smoke_config("mamba2-370m").ssm
    ts, ds = 2 * ssm.chunk_size, 128           # mamba2 smoke's width: w_in cut inside x
    tree = {"layers": [{"ssd": _scaled(ssd_lib.init_ssd(_gen(50), ds, ssm, torch.float32,
                                                        "cpu"), 5)}]}
    out["ssd"] = _compare(lambda tr, x: ssd_lib.ssd_block(tr["layers"][0]["ssd"], x, ssm),
                          tree, [0.5 * torch.randn((b, ts, ds), generator=_gen(2))],
                          mesh, 51)
    rg = dataclasses.replace(get_smoke_config("recurrentgemma-9b").rglru,
                             lru_width=16)
    p = _scaled(rglru_lib.init_rglru(_gen(60), d, rg, torch.float32, "cpu"), 10)
    p = {k: (v + 0.3 * torch.randn(v.shape, generator=_gen(61)) if v.dim() == 1 else v)
         for k, v in p.items()}               # non-zero biases
    out["rglru"] = _compare(lambda tr, x: rglru_lib.rglru_block(tr["layers"][0]["rec"], x, rg),
                            {"layers": [{"rec": p}]}, [x], mesh, 62)
    every = [None] * 2
    torch.distributed.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def pieces():
    return tmesh.spawn_workers(_rank_kinds, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("piece", PIECES)
def test_layer_piece_matches_whole(pieces, piece):
    for rank in pieces:
        err, sharded = rank[piece]
        assert err <= TOL, (piece, err)
        assert sharded > 0, piece          # the piece really ran sharded


# ------------------------------------------------------ the reference ----

def _start_reference(code: str):
    """A fresh process running `code` on 4 forced host devices, started
    now and read by `_reference_output` (the reference's parts run beside
    each other and beside the port's ranks)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _reference_output(proc) -> str:
    out, err = proc.communicate(timeout=TIMEOUT_S * 2)
    if proc.returncode != 0:
        raise AssertionError(f"reference process failed:\n{out}\n{err}")
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's grid steps (two processes) and training loops (two
    processes), all started at once; each entry a callable that waits for
    its part."""
    root = tmp_path_factory.mktemp("ref")
    procs = {}
    for i, part in enumerate((CASES[::2], CASES[1::2])):
        path = str(root / f"grid{i}.npz")
        procs[f"grid{i}"] = (_start_reference(_JAX_GRID % dict(
            cases=part, steps=STEPS, lr=LR, metrics=METRICS, snaps=SNAPS,
            path=path)), path)
    for name, jobs in LOOPS.items():
        procs[name] = (_start_reference(_JAX_LOOPS % dict(jobs=jobs,
                                                         keys=LOOP_KEYS)), None)

    def grid():
        out = {}
        for name, (proc, path) in procs.items():
            if name.startswith("grid"):
                assert "SAVED" in _reference_output(proc)
                out.update(np.load(path))
        return out

    def loops(name):
        return json.loads(_reference_output(procs[name][0]).split("HIST ", 1)[1])

    yield {"grid": grid, "loops": loops}
    for proc, _ in procs.values():
        proc.kill()
        proc.communicate()


# ------------------------------------------------------ steps on a grid ----

STEPS = 3
SNAPS = (0, STEPS - 1)
SHARES = (5e-4, 2.5e-2)
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")
PLAN = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
LR = 1e-3
KINDS = ("dbrx-132b", "deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b")
# (step, arch, stats_impl, params_impl, (data, model))
CASES = ([(step, a, "flat", "flat", (2, 2)) for step in ("fsdp_norm", "accum_norm")
          for a in KINDS]
         + [c for s, p in (("flat", "tree"), ("tree", "flat"))
            for c in (("fsdp_norm", "recurrentgemma-9b", s, p, (2, 2)),
                      ("accum_norm", "deepseek-v2-236b", s, p, (2, 2)))])

_JAX_GRID = """
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.core.schedule import BatchPlan
from repro.data.pipeline import MarkovTokens, make_batch
from repro.distributed.train_step import make_accum_norm_step, make_fsdp_norm_step
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat

plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
out = {}
for step_impl, arch, stats, pimpl, (d, m) in %(cases)r:
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    mesh = make_host_mesh(data=d, model=m)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    batches = [jax.tree.map(jnp.asarray, make_batch(src, t, plan, 16))
               for t in range(%(steps)d)]
    params = model.init(jax.random.PRNGKey(0))
    make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
    wrap, _, _ = make(model, AdamWConfig(), mesh, stats_impl=stats,
                      params_impl=pimpl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, shard_divisor=d, layout=layout)
           if stats == "flat" else init_adamw(params))
    if pimpl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if pimpl == "flat"
            else (lambda p: p))
    tag = f"{step_impl}/{arch}/{stats}-{pimpl}/{d}x{m}"
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


def _tag(case):
    step_impl, arch, stats, pimpl, (d, m) = case
    return f"{step_impl}/{arch}/{stats}-{pimpl}/{d}x{m}"


def _grid_rank(cases, inits, batches):
    """This rank's steps for every case on its grid (the ranks of the
    process group are the grid), in the residencies `run_training` keeps:
    rank 0's metrics and whole parameters."""
    out = {}
    world = torch.distributed.get_world_size()
    for case, init_np in zip(cases, inits):
        step_impl, arch, stats, pimpl, (d, m) = case
        if d * m != world:
            continue
        mesh = tmesh.make_host_mesh(data=d, model=m)
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = params_from_jax(init_np, cfg)
        make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
        wrap = make(model, AdamWConfig(), stats_impl=stats, params_impl=pimpl,
                    params_like=params, mesh=mesh)
        layout, specs = wrap.flat_layout, wrap.param_specs
        if pimpl == "tree":
            params = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                              tparams.shard_tree(params, specs, mesh))
        opt = (init_adamw_flat(params, shard_divisor=d, layout=layout)
               if stats == "flat" else init_adamw(params))
        if pimpl == "flat":
            params = tuple(shard_flat_buffers(layout.flatten(params), mesh))
        for t, b in enumerate(batches[arch]):
            params, opt, mt = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                      torch.tensor(LR))
            for k in METRICS:
                out[f"{_tag(case)}/{k}/{t}"] = float(mt[k])
            if t in SNAPS:
                full = (layout.unflatten(gather_flat_buffers(params, mesh=mesh))
                        if pimpl == "flat" else tparams.gather_tree(params, specs, mesh))
                out[f"{_tag(case)}/snap{t}"] = [x.detach().clone() for x in tree_leaves(full)]
    return out


@pytest.fixture(scope="module")
def port_grid():
    """The port's steps on one process group of 4 gloo ranks."""
    inits = [jax_tree_np(jbuild(jget(c[1])).init(jax.random.PRNGKey(0))) for c in CASES]
    batches = {a: [make_batch(MarkovTokens(vocab_size=get_smoke_config(a).vocab_size,
                                           seed=0), t, PLAN, 16) for t in range(STEPS)]
               for a in KINDS}
    return tmesh.spawn_workers(_grid_rank, 4, CASES, inits, batches,
                               timeout_s=TIMEOUT_S), inits


@pytest.fixture(scope="module")
def jax_grid(reference, port_grid):
    return reference["grid"]()


@pytest.mark.parametrize("case", CASES, ids=lambda c: _tag(c).replace("/", "-"))
def test_grid_steps_match_reference(jax_grid, port_grid, case):
    got, inits = port_grid
    tag = _tag(case)
    for t in range(STEPS):
        for k in METRICS:
            np.testing.assert_allclose(got[f"{tag}/{k}/{t}"], jax_grid[f"{tag}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7, err_msg=f"{tag} step {t} {k}")
    assert got[f"{tag}/var_l1/0"] > 0
    treedef = jax.tree.structure(inits[CASES.index(case)])
    cfg = get_smoke_config(case[1])
    for t, share in zip(SNAPS, SHARES):
        leaves = [jax_grid[f"{tag}/snap{t}/{i}"] for i in range(treedef.num_leaves)]
        want_tree = params_from_jax(jax.tree.unflatten(treedef, leaves), cfg)
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(want_tree)])
        have = np.concatenate([g.float().numpy().ravel() for g in got[f"{tag}/snap{t}"]])
        np.testing.assert_allclose(have, want, rtol=0, atol=1e-4,
                                   err_msg=f"{tag} after step {t + 1}")
        off = np.abs(have - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (tag, t + 1, off.mean())


# -------------------------------------------------------------- the loop ----

LOOP = dict(smoke=True, schedule="adaptive", eta=0.12, stats_impl="tree",
            params_impl="tree", steps=4, seq_len=16, base_global_batch=4,
            max_global_batch=16, base_micro_batch=2, max_micro_batch=4,
            base_accum=2, eval_every=0)
LOOPS = {"fsdp": [dict(LOOP, arch=a, step_impl="fsdp_norm", mesh_data=2, mesh_model=2,
                       base_accum=1) for a in KINDS],
         "accum": [dict(LOOP, arch=a, step_impl="accum_norm", mesh_data=1, mesh_model=2)
                   for a in KINDS]}
LOOP_KEYS = ("global_batch", "samples", "accum_steps", "loss", "var_l1", "grad_sqnorm")

_JAX_LOOPS = """
import json
from repro.launch.train import TrainJob, run_training
out = []
for job in %(jobs)r:
    h = run_training(TrainJob(**job))
    out.append({k: h[k] for k in %(keys)r})
print("HIST", json.dumps(out))
"""


def _rank_loops(jobs, inits):
    """`run_training` of each job as this rank of the process group, from
    the reference's initial parameters; rank 0's histories."""
    from repro_torch.models import model as tmodel
    out = []
    for job, init_np in zip(jobs, inits):
        cfg = get_smoke_config(job["arch"])
        tmodel.Model.init = lambda self, seed=0, device="cpu", cfg=cfg, init_np=init_np: \
            params_from_jax(init_np, cfg, device)
        hist = run_training(TrainJob(device="cpu", **job))
        out.append({k: hist[k] for k in (*LOOP_KEYS, "ranks", "workers")})
    return out


@pytest.mark.parametrize("step_impl", list(LOOPS))
def test_loops_match_reference(reference, step_impl):
    """Every config's batch trajectory equals the reference's, its losses,
    var_l1 and grad_sqnorm to rtol 1e-5, and the model axis ran."""
    jobs = LOOPS[step_impl]
    inits = [jax_tree_np(jbuild(jget(j["arch"])).init(jax.random.PRNGKey(0))) for j in jobs]
    world = jobs[0]["mesh_data"] * jobs[0]["mesh_model"]
    got = tmesh.spawn_workers(_rank_loops, world, jobs, inits, timeout_s=TIMEOUT_S)
    want = reference["loops"](step_impl)
    for job, g, w in zip(jobs, got, want):
        for k in ("global_batch", "samples", "accum_steps"):
            assert g[k] == w[k], (job["arch"], k)
        for k in ("loss", "var_l1", "grad_sqnorm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"{job['arch']} {k}")
        assert all(r["tp_allreduce_calls"] > 0 for r in g["ranks"])
        assert all(v > 0 for v in g["var_l1"])
    assert len(set(got[0]["global_batch"])) > 1          # the batch grew
