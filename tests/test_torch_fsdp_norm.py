"""Port FSDP-Norm against the reference's, on the CPU with J gloo ranks
(one spawned process per worker) — the reference runs on J forced host
devices in a subprocess.

* The step: 5 steps of `make_fsdp_norm_step` at J = 2 on smoke
  llama3.2-1b for (tree, tree) and (flat, flat), from the same converted
  parameters and batch stream.  Metrics at rtol 1e-5 / atol 1e-7;
  parameters by the per-entry-share rule of tests/test_torch_train_step.py
  (every entry to lr/10 = 1e-4, all but 0.05 % after step 1 and 2.5 %
  after step 5 to rtol 1e-5 / atol 1e-7: AdamW's m̂/√v̂ is ill-conditioned
  for gradient entries within a few eps of zero).
* The statistic: var_l1 at J = 4 against a brute-force (1/J)Σ_j‖g_j − g‖²
  (rel 1e-3), and the paper-literal full-vector variance equal to the
  scalar one (rel 1e-4), as tests/test_distributed.py holds the reference.
* The loop: `run_training` with FSDP-Norm at J = 2 takes the reference's
  batch trajectory exactly and its losses to rtol 1e-5.

The reference's padded multi-worker gradient is not a reliable 1e-5 anchor
on this JAX (ROADMAP §3), so every comparison here is unpadded."""

import json
import math
import time

import numpy as np
import pytest
import torch

import jax

from conftest import run_subprocess
from test_torch_helpers import jax_tree_np

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.core.norm_test import tree_sqdiff, tree_sqnorm
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed.sharding import gather_flat_buffers, shard_flat_buffers
from repro_torch.distributed.train_step import batch_to_device, make_fsdp_norm_step
from repro_torch.launch import mesh
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

STEPS = 5
SNAPS = (0, STEPS - 1)                 # parameters are compared after these
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")
ARCH = "llama3.2-1b"
IMPLS = ("tree", "flat")                # both residencies, parameters and stats
PLAN = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
LR = 1e-3
TIMEOUT_S = 300          # every spawned run here takes well under a minute

_JAX_STEPS = """
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

cfg = get_smoke_config(%(arch)r)
model = build_model(cfg)
mesh = make_host_mesh(data=2, model=1)
src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
batches = [jax.tree.map(jnp.asarray, make_batch(src, t, plan, 16))
           for t in range(%(steps)d)]
out = {}
for impl in %(impls)r:
    params = model.init(jax.random.PRNGKey(0))
    wrap, _, _ = make_fsdp_norm_step(model, AdamWConfig(), mesh,
                                     stats_impl=impl, params_impl=impl,
                                     params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, shard_divisor=2, layout=layout)
           if impl == "flat" else init_adamw(params))
    if impl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if impl == "flat"
            else (lambda p: p))
    with set_mesh(mesh):
        fn = wrap(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                               batches[0]))
        for t, b in enumerate(batches):
            params, opt, m = fn(params, opt, b, jnp.float32(%(lr)r))
            for k in %(metrics)r:
                out[f"{impl}/{k}/{t}"] = np.float64(m[k])
            if t in %(snaps)r:
                for i, leaf in enumerate(jax.tree.leaves(view(params))):
                    out[f"{impl}/snap{t}/{i}"] = np.asarray(leaf, np.float32)
np.savez(%(path)r, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The reference's 5 FSDP-Norm steps at data=2, both residencies."""
    path = str(tmp_path_factory.mktemp("fsdp") / "ref.npz")
    out = run_subprocess(_JAX_STEPS % dict(arch=ARCH, impls=IMPLS, steps=STEPS,
                                           lr=LR, metrics=METRICS, snaps=SNAPS,
                                           path=path), devices=2)
    assert "SAVED" in out
    return dict(np.load(path))


def _batches(plan=PLAN, seq=16, steps=STEPS, arch=ARCH):
    src = MarkovTokens(vocab_size=get_smoke_config(arch).vocab_size, seed=0)
    return [make_batch(src, t, plan, seq) for t in range(steps)]


def _rank_steps(impl, init_np, arch, batches, variance_impl="scalar"):
    """One worker's FSDP-Norm steps from converted (or the port's own, when
    `init_np` is None) parameters; returns (metrics per step, the full
    parameter leaves after each step of SNAPS)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = (params_from_jax(init_np, cfg) if init_np is not None
              else model.init(0, "cpu"))
    wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl=impl,
                               params_impl=impl, variance_impl=variance_impl,
                               params_like=params)
    layout = wrap.flat_layout
    if impl == "flat":
        opt = init_adamw_flat(params, shard_divisor=mesh.num_workers(),
                              layout=layout)
        params = tuple(shard_flat_buffers(layout.flatten(params)))
    else:
        opt = init_adamw(params)
    traj, snaps = [], []
    for t, b in enumerate(batches):
        params, opt, m = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                 torch.tensor(LR))
        traj.append({k: float(x) for k, x in m.items()})
        if t in SNAPS:
            full = (layout.unflatten(gather_flat_buffers(params))
                    if impl == "flat" else params)
            snaps.append([x.detach().clone() for x in tree_leaves(full)])
    return traj, snaps


@pytest.mark.parametrize("impl", IMPLS)
def test_fsdp_norm_step_matches_reference(jax_steps, impl):
    cfg = get_smoke_config(ARCH)
    jmodel = jbuild(jget(ARCH))
    init_np = jax_tree_np(jmodel.init(jax.random.PRNGKey(0)))
    traj, snaps = mesh.spawn_workers(_rank_steps, 2, impl, init_np, ARCH,
                                     _batches(), timeout_s=TIMEOUT_S)
    assert len(traj) == STEPS
    for t, got in enumerate(traj):
        for k in METRICS:
            np.testing.assert_allclose(got[k], jax_steps[f"{impl}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {t} {k}")
    assert traj[0]["var_l1"] > 0                 # two workers: a live signal
    treedef = jax.tree.structure(init_np)
    for t, share, got in zip(SNAPS, (5e-4, 2.5e-2), snaps):
        leaves = [jax_steps[f"{impl}/snap{t}/{i}"]
                  for i in range(treedef.num_leaves)]
        want_tree = params_from_jax(jax.tree.unflatten(treedef, leaves), cfg)
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(want_tree)])
        got = np.concatenate([g.float().numpy().ravel() for g in got])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"after step {t + 1}")
        off = np.abs(got - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (t + 1, off.mean())


def _rank_one_step(arch, batch, variance_impls):
    """var_l1 and grad_sqnorm of one tree/tree step from the port's own
    parameters, for each variance implementation (fresh params each)."""
    return {vi: _rank_steps("tree", None, arch, [batch], vi)[0][0]
            for vi in variance_impls}


def test_fsdp_norm_matches_bruteforce():
    """J = 4: the step's var_l1 and ‖g‖² against the per-worker gradients
    computed one by one."""
    plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=1, workers=4)
    batch = _batches(plan, steps=1)[0]
    got = mesh.spawn_workers(_rank_one_step, 4, ARCH, batch, ("scalar",),
                             timeout_s=TIMEOUT_S)["scalar"]
    model = build_model(get_smoke_config(ARCH))
    leaves, treedef = tree_flatten(model.init(0, "cpu"))
    gs = []
    for j in range(4):
        mb = {k: torch.as_tensor(v[0, 2 * j:2 * (j + 1)]) for k, v in batch.items()}
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree_unflatten(treedef, xs), mb)[0]
        gs.append(list(torch.autograd.grad(loss, xs)))
    gmean = [sum(g[i] for g in gs) / 4 for i in range(len(leaves))]
    var_l1 = float(sum(tree_sqdiff(g, gmean) for g in gs)) / 4
    gsq = float(tree_sqnorm(gmean))
    assert abs(var_l1 - got["var_l1"]) / max(var_l1, 1e-9) < 1e-3, (var_l1, got)
    assert abs(gsq - got["grad_sqnorm"]) / gsq < 1e-3, (gsq, got)


def test_paper_vs_scalar_variance_equal():
    """The scalar all-reduce statistic equals the paper-literal full-vector
    all-reduce (DESIGN §7.1), J = 4."""
    plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=1, workers=4)
    batch = _batches(plan, steps=1, arch="tinyllama-1.1b")[0]
    vals = mesh.spawn_workers(_rank_one_step, 4, "tinyllama-1.1b", batch,
                              ("scalar", "paper"), timeout_s=TIMEOUT_S)
    s, p = vals["scalar"]["var_l1"], vals["paper"]["var_l1"]
    assert s > 0 and abs(s - p) / s < 1e-4, (s, p)


LOOP = dict(arch="llama3.2-1b", smoke=True, schedule="adaptive", eta=0.12,
            step_impl="fsdp_norm", stats_impl="flat", params_impl="flat",
            mesh_data=2, steps=6, seq_len=32, base_global_batch=4,
            max_global_batch=16, base_micro_batch=2, max_micro_batch=4,
            base_accum=1, eval_every=0)
LOOP_KEYS = ("global_batch", "samples", "accum_steps", "loss")


def _rank_loop(job, init_np):
    """`run_training` as one rank of an existing group, from the reference's
    initial parameters."""
    from repro_torch.models import model as tmodel
    cfg = get_smoke_config(job.arch)
    tmodel.Model.init = lambda self, seed=0, device="cpu": params_from_jax(
        init_np, cfg, device)
    hist = run_training(job)
    return {k: hist[k] for k in (*LOOP_KEYS, "var_l1", "ranks", "workers")}


def test_fsdp_norm_loop_matches_reference():
    """The adaptive loop with two FSDP-Norm workers: the reference's batch
    trajectory exactly, its losses to rtol 1e-5."""
    code = ("import json\n"
            "from repro.launch.train import TrainJob, run_training\n"
            f"h = run_training(TrainJob(**{LOOP!r}))\n"
            f"print('HIST', json.dumps({{k: h[k] for k in {LOOP_KEYS!r}}}))\n")
    out = run_subprocess(code, devices=2)
    want = json.loads(out.split("HIST ", 1)[1])
    init_np = jax_tree_np(jbuild(jget(LOOP["arch"])).init(jax.random.PRNGKey(0)))
    got = mesh.spawn_workers(_rank_loop, 2, TrainJob(device="cpu", **LOOP),
                             init_np, timeout_s=TIMEOUT_S)
    for k in ("global_batch", "samples", "accum_steps"):
        assert got[k] == want[k], k
    assert len(set(got["global_batch"])) > 1          # the batch grew
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["workers"] == 2 and len(got["ranks"]) == 2
    assert all(v > 0 and math.isfinite(v) for v in got["var_l1"])


def test_spawned_workers_train_and_report_their_launches():
    """With no process group, `run_training` spawns the J ranks itself and
    returns rank 0's history; each rank reports its own kernel launches
    (none on the CPU: the plain versions run there)."""
    job = TrainJob(device="cpu", **{**LOOP, "steps": 2})
    hist = run_training(job)
    assert hist["workers"] == 2 and len(hist["loss"]) == 2
    assert all(math.isfinite(x) for x in hist["loss"])
    assert [r["launches"] for r in hist["ranks"]] == [
        {"fused_adamw_stats": 0, "fused_adamw": 0, "fused_stats": 0,
         "sqdiff_norm": 0, "rmsnorm": 0, "flash_attention": 0, "dense": 0}] * 2
    leaves = tree_leaves(hist["final_params"])
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def _rank_fails(bad_rank):
    if mesh.worker_index() == bad_rank:
        raise RuntimeError("planted failure")
    torch.distributed.barrier()          # the healthy rank waits here


def test_spawn_stops_every_rank_when_one_fails():
    with pytest.raises(RuntimeError, match="planted failure"):
        mesh.spawn_workers(_rank_fails, 2, 1, timeout_s=TIMEOUT_S)
    with pytest.raises(TimeoutError):
        mesh.spawn_workers(time.sleep, 2, 60, timeout_s=1.0)


_NO_PROCESS_LEFT = """
from pathlib import Path
from repro_torch.launch import mesh

def children():
    return [pid for f in Path("/proc/self/task").glob("*/children")
            for pid in f.read_text().split()]

assert mesh.spawn_workers(mesh.worker_index, 2) == 0
print("after success", children())
try:
    mesh.spawn_workers(mesh.rank_device, 2, "no-such-device", 0)
except RuntimeError as e:
    assert "worker ranks failed" in str(e)
print("after failure", children())
"""


def test_spawn_leaves_no_process_behind():
    """In a fresh process, every process `spawn_workers` starts has ended
    when it returns, on success and on failure: the ranks and the resource
    tracker that the spawn start method starts beside them (which would
    otherwise outlive the parent)."""
    out = run_subprocess(_NO_PROCESS_LEFT)
    assert out.splitlines() == ["after success []", "after failure []"]


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="card per rank"):
        mesh.init_workers("nccl", 0, 2, "file:///nonexistent")
    with pytest.raises(ValueError, match="backend"):
        mesh.init_workers("mpi", 0, 2, "file:///nonexistent")
    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"
    assert (mesh.num_workers(), mesh.worker_index()) == (1, 0)


def test_worker_variance_forms_agree_on_one_worker():
    """With one worker (no group, no collective) the tree, packed-flat and
    born-flat statistics and the paper-literal one give the same pair, and
    the packed form hands back the mean gradient's buffers."""
    from repro_torch.core.norm_test import (
        paper_faithful_worker_variance, worker_variance_stats,
        worker_variance_stats_buffers, worker_variance_stats_flat)
    from repro_torch.distributed.flatbuf import FlatLayout
    from repro_torch.kernels import ops
    r = np.random.default_rng(3)
    tree = lambda: {"a": torch.from_numpy(r.standard_normal((7, 5)).astype(np.float32)),
                    "b": [torch.from_numpy(r.standard_normal(33).astype(np.float32))]}
    g_j, g = tree(), tree()
    want = (float(tree_sqdiff(g_j, g)), float(tree_sqnorm(g)))
    layout = FlatLayout.from_tree(g, bucket_bytes=64)
    flat = worker_variance_stats_flat(g_j, g, layout=layout)
    assert all(torch.equal(a, b) for a, b in zip(flat[2], layout.flatten(g)))
    forms = [worker_variance_stats(g_j, g),
             worker_variance_stats(g_j, g, sqdiff_fn=ops.sqdiff_norm_tree),
             flat[:2],
             worker_variance_stats_buffers(layout.flatten(g_j), layout.flatten(g)),
             paper_faithful_worker_variance(g_j, g)]
    for var_l1, gsq in forms:
        np.testing.assert_allclose([float(var_l1), float(gsq)], want, rtol=1e-6)
