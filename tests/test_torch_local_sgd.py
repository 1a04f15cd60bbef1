"""Port local-SGD round (`repro_torch/distributed/local_step.py`) against the
reference's (tests/test_local_sgd.py): H = 3 local AdamW steps on smoke
llama3.2-1b, then one sync.  The reference runs on 2 forced host devices
in a subprocess, the port as 2 gloo ranks on the CPU, from the same
converted parameters and batches, in the three residency combinations the
reference accepts.

Tolerances: the round's loss, var_l1 and grad_sqnorm at rtol 1e-5.  The
synced parameters by the per-entry-share rule of
tests/test_torch_train_step.py: every entry to lr/10, and all but 0.05 %
to rtol 1e-5 / atol 5e-6, the reference's own flat-vs-tree tolerance for
this round (its embedding-table adjoint reorders adds across H chained
steps).  AdamW's m̂/√v̂ is ill-conditioned for gradient entries within a
few eps of zero, and the two frameworks' last-bit differences in such a
gradient move the step by up to lr: measured, 0.0119 % of the entries
(43 of 361 088) miss rtol 1e-5 / atol 5e-6, by at most 3.9e-5.  The
port's flat round against its own tree round at rtol 1e-5 / atol 5e-6.
Identical data on every worker gives a divergence statistic of exactly
zero."""

import numpy as np
import pytest
import torch

import jax

from conftest import run_subprocess
from test_torch_helpers import jax_tree_np

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed.local_step import make_local_sgd_step
from repro_torch.distributed.train_step import batch_to_device
from repro_torch.launch import mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_leaves

ARCH = "llama3.2-1b"
H = 3
LR = 5e-3
METRICS = ("loss", "var_l1", "grad_sqnorm")
COMBOS = (("tree", "tree"), ("flat", "tree"), ("flat", "flat"))
PLAN = BatchPlan(global_batch=4, micro_batch=2, accum_steps=1, workers=2)

_JAX_ROUND = """
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.core.schedule import BatchPlan
from repro.data.pipeline import MarkovTokens, make_batch
from repro.distributed.local_step import make_local_sgd_step
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat

cfg = get_smoke_config(%(arch)r)
model = build_model(cfg)
mesh = make_host_mesh(data=2, model=1)
src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
plan = BatchPlan(global_batch=4, micro_batch=2, accum_steps=1, workers=2)
bs = [make_batch(src, s, plan, 16) for s in range(%(H)d)]
batch = {k: jnp.asarray(np.stack([b[k][0] for b in bs])) for k in bs[0]}
out = {}
for stats_impl, params_impl in %(combos)r:
    params = model.init(jax.random.PRNGKey(0))
    wrap, _, _ = make_local_sgd_step(model, AdamWConfig(), mesh,
                                     stats_impl=stats_impl,
                                     params_impl=params_impl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, layout=layout) if params_impl == "flat"
           else init_adamw(params))
    if params_impl == "flat":
        params = tuple(layout.flatten(params))
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch)
    with set_mesh(mesh):
        p2, _, m = wrap(sds)(params, opt, batch, jnp.float32(%(lr)r))
    if params_impl == "flat":
        p2 = layout.unflatten(list(p2))
    tag = stats_impl + "/" + params_impl
    for k in %(metrics)r:
        out[f"{tag}/{k}"] = np.float64(m[k])
    for i, leaf in enumerate(jax.tree.leaves(p2)):
        out[f"{tag}/p{i}"] = np.asarray(leaf, np.float32)
np.savez(%(path)r, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def jax_round(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("local") / "ref.npz")
    out = run_subprocess(_JAX_ROUND % dict(arch=ARCH, H=H, combos=COMBOS,
                                           lr=LR, metrics=METRICS, path=path),
                         devices=2)
    assert "SAVED" in out
    return dict(np.load(path))


def _batch(plan=PLAN, same=False):
    """(H, B_global, seq) stacked local-step batches; `same`: every worker
    gets the first worker's rows."""
    src = MarkovTokens(vocab_size=get_smoke_config(ARCH).vocab_size, seed=0)
    bs = [make_batch(src, s, plan, 16) for s in range(H)]
    batch = {k: np.stack([b[k][0] for b in bs]) for k in bs[0]}
    if same:
        per = plan.micro_batch
        batch = {k: np.tile(v[:, :per], (1, plan.workers, 1))
                 for k, v in batch.items()}
    return batch


def _round(stats_impl, params_impl, init_np, batch, rounds=1):
    """`rounds` rounds of one combination; (metrics of each round, synced
    parameter leaves)."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = (params_from_jax(init_np, cfg) if init_np is not None
              else model.init(0, "cpu"))
    wrap = make_local_sgd_step(model, AdamWConfig(), stats_impl=stats_impl,
                               params_impl=params_impl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, layout=layout) if params_impl == "flat"
           else init_adamw(params))
    if params_impl == "flat":
        params = tuple(layout.flatten(params))
    mets = []
    for _ in range(rounds):
        params, opt, m = wrap(batch)(params, opt, batch_to_device(batch, "cpu"),
                                     torch.tensor(LR))
        mets.append({k: float(v) for k, v in m.items()})
    tree = layout.unflatten(list(params)) if params_impl == "flat" else params
    return mets, [x.detach().clone() for x in tree_leaves(tree)]


def _rank_rounds(init_np):
    out = {c: _round(*c, init_np, _batch()) for c in COMBOS}
    # the round's divergence signal: replicas that saw the same data for a
    # round after a sync stay together
    same = _batch(same=True)
    out["same"] = _round("flat", "flat", init_np, same, rounds=2)[0]
    return out


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])


def test_local_sgd_round_matches_reference(jax_round):
    init_np = jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(0)))
    got = mesh.spawn_workers(_rank_rounds, 2, init_np, timeout_s=300)
    treedef = jax.tree.structure(init_np)
    cfg = get_smoke_config(ARCH)
    for stats_impl, params_impl in COMBOS:
        tag = f"{stats_impl}/{params_impl}"
        mets, leaves = got[(stats_impl, params_impl)]
        for k in METRICS:
            np.testing.assert_allclose(mets[0][k], jax_round[f"{tag}/{k}"],
                                       rtol=1e-5, err_msg=f"{tag} {k}")
        assert mets[0]["var_l1"] > 0 and mets[0]["grad_sqnorm"] > 0
        want = params_from_jax(jax.tree.unflatten(treedef, [
            jax_round[f"{tag}/p{i}"] for i in range(treedef.num_leaves)]), cfg)
        got_p, want_p = _flat(leaves), _flat(tree_leaves(want))
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=LR / 10,
                                   err_msg=tag)
        off = np.abs(got_p - want_p) > 5e-6 + 1e-5 * np.abs(want_p)
        assert off.mean() <= 5e-4, (tag, off.mean())
    first, second = got["same"]
    assert first["var_l1"] == 0.0 and second["var_l1"] == 0.0
    assert second["grad_sqnorm"] > 0


def test_local_sgd_flat_resident_matches_tree():
    """One worker: the flat-resident round (gradients born flat, buffer
    AdamW, buffer statistic) reproduces the tree round."""
    plan = BatchPlan(global_batch=2, micro_batch=2, accum_steps=1, workers=1)
    batch = _batch(plan)
    (mt, pt), (mf, pf) = (_round(*c, None, batch, rounds=2)
                          for c in (("tree", "tree"), ("flat", "flat")))
    for a, b in zip(mt, mf):
        for k in METRICS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-8,
                                       err_msg=k)
    np.testing.assert_allclose(_flat(pf), _flat(pt), rtol=1e-5, atol=5e-6)


def test_local_sgd_rejects_tree_stats_over_flat_params():
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(ValueError, match="no tree-oracle tail"):
        make_local_sgd_step(model, AdamWConfig(), stats_impl="tree",
                            params_impl="flat", device="cpu")
    with pytest.raises(ValueError):
        make_local_sgd_step(model, AdamWConfig(), stats_impl="x", device="cpu")
