"""Tensor parallelism on the CPU: the port's pieces against their whole
versions on 2 gloo ranks, remat="tp_boundary", the loop on a 2 × 2 grid
against the reference, a checkpoint from the grid, and every config on a
model axis.

* Attention (kv heads sharded, and kv heads that do not divide the axis,
  replicated by the sanitizer: each local q head reads its kv head by its
  global index; softcap, window, qk-norm, cross-attention), SwiGLU, GeGLU,
  GELU and squared ReLU, the vocab-parallel lookup and cross-entropy (tied
  and untied tables, the final softcap, `xent_chunk`, masked labels):
  output and every gradient of the TP version equal the whole version's
  to 1e-5 (a "partial" leaf's gradient summed over the model group first).
* `tp_boundary`: gradients equal to remat="none" to 1e-6, on the model
  axis and without one, and its forward all-reduces run once (remat="full"
  runs them again in the backward pass).
* `run_training` with FSDP-Norm on 2 × 2 takes the reference's batch
  trajectory exactly, its losses to rtol 1e-5 (the reference on 4 forced
  host devices).
* A checkpoint written on 2 × 2 (FSDP-Norm's model slices; ACCUM-NORM's
  ZeRO-3 slices) resumes bit-identically on the grid, and the reference's
  store reads it: its parameters equal the run's.
* Every config's FSDP-Norm steps on a (1, 2) mesh equal one process's,
  and mamba2's, recurrentgemma's, dbrx's and deepseek-v2's ACCUM-NORM
  steps too; a mixed residency trains on a model axis; a model axis that
  does not divide the world, or a grid it does not fill, is refused."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from conftest import run_subprocess
from test_torch_helpers import jax_tree_np

from repro.checkpoint import store as jstore
from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import params as tparams
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, TP_STATS, use_sharding_rules)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax, stack_layers
from repro_torch.models.embeddings import embed_tokens
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.model import build_model
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

TIMEOUT_S = 300
TOL = 1e-5
ATTN_CASES = {  # name: (heads, kv heads, options)
    "gqa-kv-sharded": (4, 2, dict(softcap=30.0)),
    "kv-replicated": (4, 1, dict(window=5)),
    "mha-qk-norm": (4, 4, dict(qk_norm=True)),
    "cross": (4, 2, dict(cross=True)),
}
MLP_KINDS = ("swiglu", "geglu", "gelu", "relu2")
XENT_CASES = {"tied-softcap": ("gemma2-27b", 0), "untied-chunked": ("tinyllama-1.1b", 4)}
PIECES = ([f"attention-{k}" for k in ATTN_CASES] + [f"mlp-{k}" for k in MLP_KINDS]
          + [f"vocab-{k}" for k in XENT_CASES])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(shape, seed, scale=1.0):
    return scale * torch.randn(shape, generator=_gen(seed))


def _compare(fn, params, inputs, mesh, seed):
    """max abs error of `fn(params, *inputs)` and of every gradient (inputs
    and leaves), TP against whole, on this rank.  `params` is a tree under
    "layers/0/..." or at the top (its specs come from `param_pspecs`)."""
    specs = tparams.param_pspecs(params, mesh)
    roles = tree_flatten(tparams.model_roles(params, specs))[0]

    def run(tree, tp):
        leaves, treedef = tree_flatten(tree)
        xs = [p.detach().clone().requires_grad_(True) for p in leaves]
        ins = [x.detach().clone().requires_grad_(x.is_floating_point())
               for x in inputs]
        ctx = use_sharding_rules(DEFAULT_RULES, mesh) if tp else use_sharding_rules(None)
        with ctx:
            out = fn(tree_unflatten(treedef, xs), *ins)
            up = _randn(out.shape, seed)
            grads = torch.autograd.grad((out * up).sum(),
                                        xs + [i for i in ins if i.requires_grad])
        return out, grads[:len(xs)], grads[len(xs):]

    out_w, gp_w, gi_w = run(params, False)
    local = tree_map(lambda x: x.contiguous(), tparams.shard_tree(params, specs, mesh))
    out_t, gp_t, gi_t = run(local, True)
    err = float((out_t - out_w).abs().max())
    for a, b in zip(gi_t, gi_w):
        err = max(err, float((a - b).abs().max()))
    want = tree_leaves(tparams.shard_tree(tree_unflatten(tree_flatten(params)[1],
                                                         list(gp_w)), specs, mesh))
    for g, w, role in zip(gp_t, want, roles):
        if role == "partial":
            g = tmesh.psum(g.clone(), mesh.model_group)
        err = max(err, float((g - w).abs().max()))
    return err, sum(r != "replicated" for r in roles)


def _rank_pieces():
    """Every piece on a (1, 2) mesh; returns {piece: (max error, leaves on
    the model axis)} of each rank."""
    torch.manual_seed(0)
    mesh = tmesh.make_host_mesh(data=1, model=2)
    out = {}
    b, t, d, hd = 2, 8, 16, 8
    x = _randn((b, t, d), 1)
    pos = torch.arange(t).expand(b, t)
    for i, (name, (h, kv, opt)) in enumerate(ATTN_CASES.items()):
        opt = dict(opt)
        p = attn.init_attention(_gen(10 + i), d, h, kv, hd, torch.float32, "cpu")
        p = tree_map(lambda w: w * 10, p)       # logits of order 1
        tree = {"layers": [{"attn": p}]}
        if opt.pop("cross", False):
            enc = _randn((b, 6, d), 2)
            fn = lambda tr, x, enc: attn.cross_attend(
                tr["layers"][0]["attn"], x, enc, num_heads=h, num_kv_heads=kv)
            out[f"attention-{name}"] = _compare(fn, tree, [x, enc], mesh, 3 + i)
            continue
        fn = lambda tr, x: attn.attend_full(
            tr["layers"][0]["attn"], x, pos, rope_theta=10000.0, num_heads=h,
            num_kv_heads=kv, **opt)
        out[f"attention-{name}"] = _compare(fn, tree, [x], mesh, 3 + i)
    for i, kind in enumerate(MLP_KINDS):
        tree = {"layers": [{"mlp": init_mlp(_gen(20 + i), d, 32, kind,
                                            torch.float32, "cpu")}]}
        tree = tree_map(lambda w: w * 10, tree)
        fn = lambda tr, x: apply_mlp(tr["layers"][0]["mlp"], x, kind, d_ff=32)
        out[f"mlp-{kind}"] = _compare(fn, tree, [x], mesh, 30 + i)
    for i, (name, (arch, chunk)) in enumerate(XENT_CASES.items()):
        cfg = get_smoke_config(arch).replace(xent_chunk=chunk)
        full = build_model(cfg).init(i, "cpu")
        tree = {k: full[k] for k in ("embed", "unembed") if k in full}
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=_gen(40 + i))
        labels = torch.randint(0, cfg.vocab_size, (b, t), generator=_gen(50 + i))
        labels[0, :3] = -1
        hidden = _randn((b, t, cfg.d_model), 60 + i)

        def fn(tr, hidden, tokens=tokens, labels=labels, cfg=cfg):
            x = embed_tokens(tr["embed"], tokens, True, cfg.d_model,
                             vocab=cfg.vocab_size)
            loss = tfm.token_loss(tr, hidden + x, labels, cfg)
            return loss.reshape(1)
        out[f"vocab-{name}"] = _compare(fn, tree, [hidden], mesh, 70 + i)
    every = [None] * 2
    torch.distributed.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def pieces():
    return tmesh.spawn_workers(_rank_pieces, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("piece", PIECES)
def test_tp_piece_matches_whole(pieces, piece):
    for rank in pieces:
        err, sharded = rank[piece]
        assert err <= TOL, (piece, err)
        assert sharded > 0, piece          # the piece really ran sharded


def _remat_grads(cfg, remat, mesh):
    model = build_model(cfg.replace(remat=remat))
    params = model.init(0, "cpu")
    if mesh is not None:
        params = tree_map(lambda x: x.contiguous(), tparams.shard_tree(
            params, tparams.param_pspecs(params, mesh), mesh))
    leaves, treedef = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    gen = _gen(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)}
    TP_STATS.update(calls=0, seconds=0.0)
    with use_sharding_rules(DEFAULT_RULES if mesh else None, mesh):
        loss = model.loss(tree_unflatten(treedef, xs), batch)[0]
        forward = TP_STATS["calls"]
        grads = torch.autograd.grad(loss, xs)
    return grads, forward, TP_STATS["calls"] - forward


def _rank_remat():
    mesh = tmesh.make_host_mesh(data=1, model=2)
    cfg = get_smoke_config("llama3.2-1b")
    runs = {r: _remat_grads(cfg, r, mesh) for r in ("none", "tp_boundary", "full")}
    err = max(float((a - b).abs().max()) for a, b in
              zip(runs["none"][0], runs["tp_boundary"][0]))
    return {"err": err, "calls": {r: v[1:] for r, v in runs.items()}}


def test_tp_boundary_gradients_equal_no_remat():
    got = tmesh.spawn_workers(_rank_remat, 2, timeout_s=TIMEOUT_S)
    assert got["err"] <= 1e-6, got
    fwd, bwd = got["calls"]["none"]
    # the backward pass re-runs no forward all-reduce under tp_boundary,
    # and re-runs the layers' under full recomputation
    assert got["calls"]["tp_boundary"] == (fwd, bwd)
    assert got["calls"]["full"][1] > bwd
    cfg = get_smoke_config("llama3.2-1b")
    none, _, _ = _remat_grads(cfg, "none", None)
    boundary, calls, _ = _remat_grads(cfg, "tp_boundary", None)
    assert calls == 0
    assert max(float((a - b).abs().max()) for a, b in zip(none, boundary)) <= 1e-6


# ------------------------------------------------------------- the loop ----

LOOP = dict(arch="llama3.2-1b", smoke=True, schedule="adaptive", eta=0.12,
            step_impl="fsdp_norm", stats_impl="tree", params_impl="tree",
            mesh_data=2, mesh_model=2, steps=6, seq_len=32, base_global_batch=4,
            max_global_batch=16, base_micro_batch=2, max_micro_batch=4,
            base_accum=1, eval_every=3, eval_batches=1)
LOOP_KEYS = ("global_batch", "samples", "accum_steps", "loss", "val_loss")


def _use_reference_init(init_np, arch):
    from repro_torch.models import model as tmodel
    cfg = get_smoke_config(arch)
    tmodel.Model.init = lambda self, seed=0, device="cpu": params_from_jax(
        init_np, cfg, device)


def _rank_loop(job, init_np):
    _use_reference_init(init_np, job.arch)
    hist = run_training(job)
    return {k: hist[k] for k in (*LOOP_KEYS, "var_l1", "ranks", "workers")}


def test_loop_on_2x2_matches_reference():
    code = ("import json\n"
            "from repro.launch.train import TrainJob, run_training\n"
            f"h = run_training(TrainJob(**{LOOP!r}))\n"
            f"print('HIST', json.dumps({{k: h[k] for k in {LOOP_KEYS!r}}}))\n")
    want = json.loads(run_subprocess(code, devices=4).split("HIST ", 1)[1])
    init_np = jax_tree_np(jbuild(jget(LOOP["arch"])).init(jax.random.PRNGKey(0)))
    got = tmesh.spawn_workers(_rank_loop, 4, TrainJob(device="cpu", **LOOP),
                              init_np, timeout_s=TIMEOUT_S)
    for k in ("global_batch", "samples", "accum_steps"):
        assert got[k] == want[k], k
    assert len(set(got["global_batch"])) > 1          # the batch grew
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["workers"] == 2 and len(got["ranks"]) == 4
    assert all(r["tp_allreduce_calls"] > 0 for r in got["ranks"])
    assert all(v > 0 for v in got["var_l1"])


# ---------------------------------------------------------- checkpoints ----

CKPT = dict(arch="llama3.2-1b", smoke=True, schedule="adaptive", eta=0.12,
            stats_impl="tree", params_impl="tree", mesh_data=2, mesh_model=2,
            seq_len=16, base_global_batch=4, max_global_batch=16,
            base_micro_batch=2, max_micro_batch=2, base_accum=2,
            total_samples=128, eval_every=2, eval_batches=1,
            checkpoint_every=2)


def _rank_resume(job_kw, root, init_np):
    """4 steps with checkpoints at 2 and 4; step 2's copied to a second
    directory and resumed there to 4."""
    _use_reference_init(init_np, job_kw["arch"])
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    full = run_training(TrainJob(device="cpu", steps=4, checkpoint_dir=a, **job_kw))
    if torch.distributed.get_rank() == 0:
        os.makedirs(b)
        for f in os.listdir(a):
            if "00000002" in f:
                shutil.copy(os.path.join(a, f), b)
    torch.distributed.barrier()
    resumed = run_training(TrainJob(device="cpu", steps=4, checkpoint_dir=b,
                                    resume=True, **job_kw))
    keys = ("loss", "val_loss", "var_l1", "global_batch", "resumed_from")
    return ({k: full[k] for k in keys}, {k: resumed[k] for k in keys},
            stack_layers(full["final_params"], get_smoke_config(job_kw["arch"])))


@pytest.mark.parametrize("step_impl", ["fsdp_norm", "accum_norm"])
def test_grid_checkpoint_resumes_bit_identically_and_crosses(tmp_path, step_impl):
    job = dict(CKPT, step_impl=step_impl)
    jmodel = jbuild(jget(job["arch"]))
    init_np = jax_tree_np(jmodel.init(jax.random.PRNGKey(0)))
    full, resumed, final = tmesh.spawn_workers(_rank_resume, 4, job, str(tmp_path),
                                               init_np, timeout_s=TIMEOUT_S)
    assert resumed["resumed_from"] == 2 and full["resumed_from"] is None
    for k in ("loss", "var_l1", "global_batch"):
        assert resumed[k] == full[k][2:], k
    assert resumed["val_loss"][-1] == full["val_loss"][-1]
    # both step-4 checkpoints hold the same bits
    with np.load(tmp_path / "a" / "ckpt_00000004.npz") as x, \
            np.load(tmp_path / "b" / "ckpt_00000004.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for f in x.files:
            assert np.array_equal(x[f], y[f]), f
    # the reference's store reads the grid's checkpoint: the run's params
    params, meta = jstore.restore_params(str(tmp_path / "a"), 4, init_np)
    assert meta["job"]["mesh_model"] == 2
    want = jax.tree.leaves(params)
    got = tree_leaves(final)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ coverage ----

def _rank_uncovered():
    mesh = tmesh.make_host_mesh(data=1, model=2)
    return {arch: _covered_steps(arch, mesh, "accum_norm") for arch in KINDS}


@pytest.fixture(scope="module")
def uncovered():
    return tmesh.spawn_workers(_rank_uncovered, 2, timeout_s=TIMEOUT_S)


KINDS = ("mamba2-370m", "recurrentgemma-9b", "dbrx-132b", "deepseek-v2-236b")


@pytest.mark.parametrize("arch", KINDS)
def test_uncovered_configs_raise_on_a_model_axis(uncovered, arch):
    """The configs the model axis once refused (SSD, RG-LRU, MoE, MLA) train
    on a (1, 2) mesh with ACCUM-NORM as on one process: its step metrics to
    rtol 1e-5 (tests/test_torch_tp_kinds.py holds them against the
    reference)."""
    for got, want in zip(uncovered[arch], _covered_steps(arch, None, "accum_norm")):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{arch} {k}")


def test_grid_refusals(monkeypatch):
    """A mixed residency trains on a model axis, and `model_roles` takes
    dbrx's experts; a model axis that does not divide the world, or a grid
    the world does not fill, is refused."""
    hist = run_training(TrainJob(device="cpu", mesh_model=2, stats_impl="flat",
                                 params_impl="tree", steps=1, seq_len=16,
                                 eval_every=0))
    assert np.isfinite(hist["loss"]).all() and len(hist["ranks"]) == 2
    mesh = tmesh.Mesh((1, 2), ("data", "model"))
    like = build_model(get_smoke_config("dbrx-132b")).init(0, "meta")
    roles = tparams.model_roles(like, tparams.param_pspecs(like, mesh))
    moe = roles["layers"][0]["mlp"]
    assert [moe[k] for k in ("w_gate", "w_up", "w_down", "router")] == [
        "sharded", "sharded", "sharded", "replicated"]
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="does not divide"):
        run_training(TrainJob(device="cpu", mesh_model=3))
    with pytest.raises(ValueError, match="needs 6 ranks"):
        run_training(TrainJob(device="cpu", mesh_data=3, mesh_model=2))


COVERED = ("llama3.2-1b", "microllama-300m", "tinyllama-1.1b", "openllama-3b",
           "gemma2-27b", "nemotron-4-15b", "phi3-mini-3.8b", "whisper-base",
           "internvl2-1b") + KINDS


def _covered_steps(arch, mesh, step_impl="fsdp_norm"):
    """Two tree/tree steps (FSDP-Norm, or ACCUM-NORM) of `arch` smoke from
    seed-0 params, on `mesh` (this rank's slices) or on one process; the
    step metrics."""
    from repro_torch.core.schedule import BatchPlan
    from repro_torch.data.pipeline import make_batch, MarkovTokens
    from repro_torch.distributed.train_step import (
        batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
    wrap = make(model, AdamWConfig(), params_like=params, mesh=mesh)
    if mesh is not None:
        params = tree_map(lambda x: x.contiguous(), tparams.shard_tree(
            params, wrap.param_specs, mesh))
    opt = init_adamw(params)
    extra = {}
    if cfg.frontend.kind == "vision_stub":
        extra["patch_embeds"] = (cfg.frontend.num_prefix_tokens, cfg.d_model)
    elif cfg.frontend.kind == "audio_stub":
        extra["frames"] = (cfg.encoder.num_frames, cfg.d_model)
    plan = BatchPlan(global_batch=4, micro_batch=2, accum_steps=2, workers=1)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    out = []
    for t in range(2):
        b = make_batch(src, t, plan, 16, extra)
        params, opt, m = wrap(b)(params, opt, batch_to_device(b, "cpu"), 1e-3)
        out.append({k: float(m[k]) for k in ("loss", "var_l1", "grad_sqnorm",
                                             "grad_norm")})
    return out


def _rank_covered():
    mesh = tmesh.make_host_mesh(data=1, model=2)
    return {arch: _covered_steps(arch, mesh) for arch in COVERED}


@pytest.fixture(scope="module")
def covered():
    return tmesh.spawn_workers(_rank_covered, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("arch", COVERED)
def test_covered_config_on_a_model_axis_matches_one_process(covered, arch):
    """Every config trains on a (1, 2) mesh as on one process: its
    FSDP-Norm step metrics to rtol 1e-5."""
    for got, want in zip(covered[arch], _covered_steps(arch, None)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{arch} {k}")
