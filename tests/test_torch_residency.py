"""All four residency combinations ({stats_impl} x {params_impl}) of both
port train steps against the differential oracle of
tests/test_train_equivalence.py: 5 steps of smoke llama3.2-1b on the same
seed and batch stream, against the reference's UNPADDED tree/tree run (its
padded multi-worker gradient is no 1e-5 anchor on this JAX, ROADMAP §3).

Tolerances.  Per-step loss, var_l1, grad_sqnorm and clip_scale against the
reference at rtol 1e-5 / atol 1e-7.  Final parameters against the port's
own tree/tree run at the oracle's rtol 1e-5 / atol 1e-6; against the
reference by the per-entry-share rule of tests/test_torch_train_step.py
(every entry to lr/10 = 1e-4, all but 2.5 % to rtol 1e-5 / atol 1e-7:
AdamW's m̂/√v̂ is ill-conditioned for gradient entries within a few eps of
zero).  With two gloo ranks, every combination against the port's J = 2
tree/tree at the oracle's tolerance.  The training loop with a mixed
combination takes the reference's batch trajectory exactly and ends in its
controller state: plan, counters and flags exactly, the two float
statistics (ema_stat, last_T, from the step metrics) to rtol 1e-5."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np

from repro.compat import set_mesh
from repro.configs import get_smoke_config as jget
from repro.data.pipeline import MarkovTokens as JMarkov, make_batch as jbatch
from repro.distributed.train_step import (
    make_accum_norm_step as jaccum, make_fsdp_norm_step as jfsdp)
from repro.core.schedule import BatchPlan as JPlan
from repro.launch.mesh import make_host_mesh
from repro.launch.train import TrainJob as JJob, run_training as jrun
from repro.models import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamW, init_adamw as jinit
from repro_torch.configs import get_smoke_config
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed.sharding import gather_flat_buffers, shard_flat_buffers
from repro_torch.distributed.train_step import (
    batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.launch import mesh
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_leaves

STEPS = 5
ARCH = "llama3.2-1b"
METRICS = ("loss", "var_l1", "grad_sqnorm", "clip_scale")
COMBOS = [(s, p) for s in ("tree", "flat") for p in ("tree", "flat")]
LR = 1e-3
_JAX_ORACLE = {}       # the reference's runs and the port's tree/tree, cached


def _jax_oracle(step_impl):
    """The reference's tree/tree trajectory on one device (cached)."""
    if step_impl not in _JAX_ORACLE:
        cfg = jget(ARCH)
        model = jbuild(cfg)
        m = make_host_mesh(data=1, model=1)
        params = model.init(jax.random.PRNGKey(0))
        init_np = jax_tree_np(params)
        make = jfsdp if step_impl == "fsdp_norm" else jaccum
        wrap, _, _ = make(model, JAdamW(), m, params_like=params)
        opt = jinit(params)
        src = JMarkov(vocab_size=cfg.vocab_size, seed=0)
        plan = JPlan(global_batch=4, micro_batch=2, accum_steps=2, workers=1)
        batches = [jax.tree.map(jnp.asarray, jbatch(src, t, plan, 16))
                   for t in range(STEPS)]
        traj = []
        with set_mesh(m):
            fn = wrap(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                   batches[0]))
            for b in batches:
                params, opt, met = fn(params, opt, b, jnp.float32(LR))
                traj.append({k: float(met[k]) for k in METRICS})
        _JAX_ORACLE[step_impl] = (init_np, traj, jax_tree_np(params))
    return _JAX_ORACLE[step_impl]


def _port_run(step_impl, stats_impl, params_impl, init_np=None, workers=1,
              plan=None):
    """5 steps of one combination; returns (metrics per step, the final
    full parameter leaves).  With `init_np` None the port's own init."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = (params_from_jax(init_np, cfg) if init_np is not None
              else model.init(0, "cpu"))
    make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
    wrap = make(model, AdamWConfig(), stats_impl=stats_impl,
                params_impl=params_impl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, shard_divisor=workers, layout=layout)
           if stats_impl == "flat" else init_adamw(params))
    if params_impl == "flat":
        params = tuple(shard_flat_buffers(layout.flatten(params)))
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    plan = plan or BatchPlan(global_batch=4, micro_batch=2, accum_steps=2,
                             workers=1)
    traj = []
    for t in range(STEPS):
        b = make_batch(src, t, plan, 16)
        params, opt, m = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                 torch.tensor(LR))
        traj.append({k: float(m[k]) for k in METRICS})
    full = (layout.unflatten(gather_flat_buffers(list(params)))
            if params_impl == "flat" else params)
    return traj, [x.detach().clone() for x in tree_leaves(full)]


def _flat(leaves):
    return np.concatenate([x.float().numpy().ravel() for x in leaves])


@pytest.mark.parametrize("step_impl", ["fsdp_norm", "accum_norm"])
@pytest.mark.parametrize("stats_impl,params_impl", COMBOS)
def test_residency_combo_matches_unpadded_oracle(step_impl, stats_impl,
                                                 params_impl):
    init_np, jtraj, jfinal = _jax_oracle(step_impl)
    traj, final = _port_run(step_impl, stats_impl, params_impl, init_np)
    for t, (got, want) in enumerate(zip(traj, jtraj)):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {t} {k}")
    if (step_impl, "own") not in _JAX_ORACLE:
        _JAX_ORACLE[step_impl, "own"] = _port_run(step_impl, "tree", "tree",
                                                  init_np)[1]
    own = _JAX_ORACLE[step_impl, "own"]
    np.testing.assert_allclose(_flat(final), _flat(own), rtol=1e-5, atol=1e-6)
    want = _flat(tree_leaves(params_from_jax(jfinal, get_smoke_config(ARCH))))
    got = _flat(final)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (np.abs(got - want) > 1e-7 + 1e-5 * np.abs(want)).mean() <= 2.5e-2


def _rank_combos():
    plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
    return {c: _port_run("fsdp_norm", *c, workers=2, plan=plan) for c in COMBOS}


def test_fsdp_two_ranks_all_combos_agree():
    """J = 2 gloo ranks: the mixed combinations rest their flat halves as
    real 1/J shards (moment shards under flat stats; param shards gathered
    each step under flat params) and match tree/tree."""
    runs = mesh.spawn_workers(_rank_combos, 2, timeout_s=300)
    o_traj, o_final = runs[("tree", "tree")]
    assert o_traj[0]["var_l1"] > 0
    for combo, (traj, final) in runs.items():
        for t, (got, want) in enumerate(zip(traj, o_traj)):
            for k in METRICS:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"{combo} step {t} {k}")
        np.testing.assert_allclose(_flat(final), _flat(o_final), rtol=1e-5,
                                   atol=1e-6, err_msg=str(combo))


LOOP = dict(arch=ARCH, smoke=True, schedule="adaptive", eta=0.3,
            step_impl="accum_norm", steps=6, seq_len=16, base_global_batch=4,
            max_global_batch=16, base_micro_batch=2, max_micro_batch=4,
            base_accum=2, eval_every=0)


@pytest.mark.parametrize("stats_impl,params_impl", [("flat", "tree"),
                                                    ("tree", "flat")])
def test_mixed_loop_plans_and_controller_match_reference(tmp_path, monkeypatch,
                                                         stats_impl, params_impl):
    kw = dict(LOOP, stats_impl=stats_impl, params_impl=params_impl)
    hj = jrun(JJob(checkpoint_dir=str(tmp_path / "j"), **kw))
    init_np = jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, device="cpu":
                        params_from_jax(init_np, self.cfg, device))
    ht = run_training(TrainJob(device="cpu", checkpoint_dir=str(tmp_path / "t"),
                               **kw))
    for k in ("global_batch", "samples", "accum_steps"):
        assert ht[k] == hj[k], k
    assert len(set(ht["global_batch"])) > 1          # the controller acted
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    ctrl = [json.load(open(os.path.join(tmp_path, d, "ckpt_00000006.json")))
            for d in ("j", "t")]
    assert ctrl[0]["controller"]["plan"] == ctrl[1]["controller"]["plan"]
    for key in ("step", "samples", "num_increases", "at_max", "ema_init"):
        assert ctrl[0]["controller"][key] == ctrl[1]["controller"][key], key
    for key in ("ema_stat", "last_T"):
        np.testing.assert_allclose(ctrl[1]["controller"][key],
                                   ctrl[0]["controller"][key], rtol=1e-5)
