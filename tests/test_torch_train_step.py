"""Port ACCUM-NORM step against the reference's, one device, 5 steps on the
same converted parameters and batch stream, for (tree, tree) and
(flat, flat) residency.

Tolerances.  Per-step loss, var_l1, grad_sqnorm, grad_norm and clip_scale
at rtol 1e-5.  Parameters: AdamW moves an entry by lr·m̂/(√v̂+eps), and for
an entry whose gradient is within a few eps (1e-8) of zero that ratio is
ill-conditioned — the last-bit differences the two frameworks' summation
orders leave in such a gradient change the step by up to lr.  So every
entry must agree to lr/10 = 1e-4, and all but a small share to rtol 1e-5 /
atol 1e-7: 0.05 % after step 1 (measured 0.016 %, entries with |g| ≤ 2e-7
against a median |g| of ~1e-3) and 2.5 % after step 5 (measured 1.35 %:
the moments carry the differences forward)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np

from repro.compat import set_mesh
from repro.configs import get_smoke_config as jget
from repro.core.schedule import BatchPlan
from repro.data.pipeline import MarkovTokens, make_batch, pad_to_bucket
from repro.distributed.train_step import make_accum_norm_step as jmake
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as jbuild
from repro.optim.adamw import (AdamWConfig as JAdamW, init_adamw as jinit,
                               init_adamw_flat as jinit_flat)
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.train_step import batch_to_device, make_accum_norm_step
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_leaves

STEPS = 5
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")
ARCH = "llama3.2-1b"
PLAN = BatchPlan(global_batch=4, micro_batch=2, accum_steps=2, workers=1)


def _batches():
    src = MarkovTokens(vocab_size=jget(ARCH).vocab_size, seed=0)
    return [make_batch(src, t, PLAN, 16) for t in range(STEPS)]


def _jax_run(impl):
    cfg = jget(ARCH)
    model = jbuild(cfg)
    mesh = make_host_mesh(data=1, model=1)
    params = model.init(jax.random.PRNGKey(0))
    init_np = jax_tree_np(params)
    wrap, _, _ = jmake(model, JAdamW(), mesh, stats_impl=impl,
                       params_impl=impl, params_like=params)
    layout = wrap.flat_layout
    opt = jinit_flat(params, layout=layout) if impl == "flat" else jinit(params)
    if impl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if impl == "flat"
            else (lambda p: p))
    traj, snaps = [], []
    batches = _batches()
    with set_mesh(mesh):
        fn = wrap(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                               batches[0]))
        for b in batches:
            params, opt, m = fn(params, opt, jax.tree.map(jnp.asarray, b),
                                jnp.float32(1e-3))
            traj.append({k: float(m[k]) for k in METRICS})
            snaps.append(jax_tree_np(view(params)))
    return init_np, traj, snaps


def _torch_run(impl, init_np, batches=None):
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = params_from_jax(init_np, cfg)
    wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl=impl,
                                params_impl=impl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, layout=layout) if impl == "flat"
           else init_adamw(params))
    if impl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if impl == "flat"
            else (lambda p: p))
    traj, snaps = [], []
    for b in batches or _batches():
        params, opt, m = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                 torch.tensor(1e-3))
        traj.append({k: float(m[k]) for k in METRICS})
        snaps.append([x.detach().clone() for x in tree_leaves(view(params))])
    return traj, snaps


@pytest.mark.parametrize("impl", ["tree", "flat"])
def test_accum_norm_step_matches_reference(impl):
    init_np, jtraj, jsnaps = _jax_run(impl)
    ttraj, tsnaps = _torch_run(impl, init_np)
    cfg = get_smoke_config(ARCH)
    for t, (a, b) in enumerate(zip(ttraj, jtraj)):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                       err_msg=f"step {t} {k}")
    for t, share in ((0, 5e-4), (STEPS - 1, 2.5e-2)):
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(
            params_from_jax(jsnaps[t], cfg))])
        got = np.concatenate([g.numpy().ravel() for g in tsnaps[t]])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"after step {t + 1}")
        off = np.abs(got - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (t + 1, off.mean())


@pytest.mark.parametrize("impl", ["tree", "flat"])
def test_padded_batch_gives_the_same_step(impl):
    """A batch padded into a larger ladder bucket (two fully padded
    microbatches, labels -1) gives the same metrics and update."""
    init_np = jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(1)))
    bucket = BatchPlan(global_batch=8, micro_batch=2, accum_steps=4, workers=1)
    plain = _batches()[:2]
    padded = [pad_to_bucket(b, PLAN, bucket) for b in plain]
    assert padded[0]["tokens"].shape[0] == 4
    ta, sa = _torch_run(impl, init_np, plain)
    tb, sb = _torch_run(impl, init_np, padded)
    for a, b in zip(ta, tb):
        for k in METRICS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    for x, y in zip(sa[-1], sb[-1]):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-7)


def test_mixed_residency_waits_for_slice_2():
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_accum_norm_step(model, AdamWConfig(), stats_impl="flat",
                             params_impl="tree")
    with pytest.raises(ValueError):
        make_accum_norm_step(model, AdamWConfig(), stats_impl="x",
                             params_impl="x")
