"""Port MoE layer against the reference's, float32 on the CPU: top-k order
on ties, the sort/capacity dispatch (the slot -> token map and the kept
set EXACTLY, at capacity factors low enough that pairs drop), `moe_apply`'s
output, aux loss and gradients, the gradient's bits at any thread count,
and FSDP-Norm at J = 2 gloo ranks on the dbrx smoke config.

The reference's dispatch is read from its own run: `_moe_row` hands the
slot -> token map and the slot gates to `maybe_shard` (its sharding hook),
which the test replaces with a recorder.  Gates come out of a softmax that
each framework rounds its own way, so they agree to rtol 1e-6, not bit for
bit; outputs and aux to rtol 1e-5 with an atol of 1e-5 × the largest
magnitude (sums in another order).

The reference sends a dropped pair to slot index n·k, a real slot whenever
E·C > n·k (capacity factor above 1): there it can overwrite a kept pair
(ROADMAP §3).  The port drops it.  So above factor 1 the port is held
against a brute-force dispatch, and the reference against the port
everywhere but that one slot."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng
import test_torch_fsdp_norm as fsdp

from conftest import run_subprocess
from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoE
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves, tree_map

D = 16


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def close(got, want, rtol=1e-5):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def _layer(seed=0, shared=0, **kw):
    """Reference MoE params (numpy) and the two configs."""
    fields = dict(num_experts=8, top_k=2, d_expert=12,
                  num_shared_experts=shared, shared_d_expert=10 if shared else 0,
                  **kw)
    jm, tm = JMoE(**fields), MoEConfig(**fields)
    p = jax_tree_np(jmoe.init_moe(jax.random.PRNGKey(seed), D, jm, "swiglu",
                                  jnp.float32))
    return jm, tm, p


def _x(seed, b, n, shift=0.0):
    """Token rows; `shift` tilts every row the same way, so the router
    favours a few experts and their capacity overflows."""
    return (rng(seed).standard_normal((b, n, D)) + shift).astype(np.float32)


def _reference_dispatch(monkeypatch, p, x, m, cf):
    """The reference's (slot_token, slot_gate) of every row, each (E, C)."""
    seen = []
    monkeypatch.setattr(jmoe, "maybe_shard",
                        lambda a, *axes: (seen.append((np.asarray(a), axes)), a)[1])
    jp = jax.tree.map(jnp.asarray, p)
    out = []
    for row in x:
        seen.clear()
        jmoe._moe_row(jp, jnp.asarray(row), m, cf, True)
        two_d = [a for a, axes in seen if axes == ("experts", None)]
        out.append((two_d[0], two_d[1]))          # slot_token, slot_gate
    return out


def _brute_force(p, x, m, cf):
    """The intended dispatch: each expert keeps its first C pairs in pair
    order (token-major, then k), a dropped pair goes nowhere."""
    e, k = m.num_experts, m.top_k
    out = []
    for row in x:
        probs = jax.nn.softmax(jnp.asarray(row) @ jnp.asarray(p["router"]), -1)
        idx = np.asarray(jax.lax.top_k(probs, k)[1]).reshape(-1)
        n = row.shape[0]
        cap = jmoe._capacity(n, m, cf)
        slots = np.full((e, cap), n)
        fill = np.zeros(e, int)
        for pair in np.argsort(idx, kind="stable"):
            if fill[idx[pair]] < cap:
                slots[idx[pair], fill[idx[pair]]] = pair // k
            fill[idx[pair]] += 1
        out.append((slots, int(np.maximum(fill - cap, 0).sum())))
    return out


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.2, 0.4, 0.2, 0.2], [0.5, 0.0, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = tmoe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0])
def test_dispatch_equals_reference_exactly_with_drops(monkeypatch, cf):
    jm, tm, p = _layer(seed=1)
    x = _x(2, 3, 24, shift=0.5)
    want = _reference_dispatch(monkeypatch, p, x, jm, cf)
    got = tmoe.route(tree_map(_t, p), torch.from_numpy(x), tm, cf)
    dropped = 0
    for r, (st, sg) in enumerate(want):
        np.testing.assert_array_equal(got["slot_token"][r].numpy(), st)
        kept = st < x.shape[1]
        assert set(zip(*np.nonzero(got["slot_token"][r].numpy() < 24))) == \
            set(zip(*np.nonzero(kept)))
        np.testing.assert_allclose(got["slot_gate"][r].numpy(), sg, rtol=1e-6,
                                   atol=0)
        assert not sg[~kept].any() and not got["slot_gate"][r][~kept].any()
        dropped += 24 * jm.top_k - int(kept.sum())
    assert dropped > 0                     # the capacity really overflowed


def test_dispatch_above_capacity_factor_one_drops_pairs_nowhere(monkeypatch):
    """Factor 1.5: every row drops pairs.  The port keeps exactly the
    brute-force set; the reference agrees with it except at flat slot n·k,
    where its last dropped pair lands."""
    cf, n = 1.5, 24
    jm, tm, p = _layer(seed=1)
    x = _x(2, 3, n, shift=0.5)
    want = _brute_force(p, x, jm, cf)
    ref = _reference_dispatch(monkeypatch, p, x, jm, cf)
    got = tmoe.route(tree_map(_t, p), torch.from_numpy(x), tm, cf)
    for r, ((slots, drops), (st, _)) in enumerate(zip(want, ref)):
        assert drops > 0
        np.testing.assert_array_equal(got["slot_token"][r].numpy(), slots)
        differ = np.flatnonzero((st != slots).ravel())
        assert set(differ) <= {n * jm.top_k}, differ


def _pair_grads(p, x, m, fn, **kw):
    """(output, aux, d(sum(out·w) + aux)/d(params, x)) through `fn`."""
    w = rng(9).standard_normal(x.shape).astype(np.float32)
    if fn == "jax":
        def f(p, x):
            y, aux = jmoe.moe_apply(p, x, m, **kw)
            return jnp.sum(y * w) + aux, (y, aux)
        (_, (y, aux)), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        return y, aux, [np32(a) for a in jax.tree.leaves(g[0])] + [np32(g[1])]
    tp = tree_map(lambda a: _t(a).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, m, **kw)
    leaves = tree_leaves(tp) + [tx]
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, leaves)
    return y, aux, [np32(a) for a in g]


@pytest.mark.parametrize("shared,cf,normalize", [(0, 2.0, True), (2, 2.0, True),
                                                 (1, 0.5, True), (0, 1.0, False)])
def test_moe_apply_output_aux_and_grads_match_reference(shared, cf, normalize):
    jm, tm, p = _layer(seed=3, shared=shared)
    x = _x(4, 2, 20, shift=0.3)
    jy, jaux, jg = _pair_grads(p, x, jm, "jax", capacity_factor=cf,
                               normalize_gates=normalize)
    ty, taux, tg = _pair_grads(p, x, dataclasses.replace(tm, norm_topk_prob=normalize),
                               "torch", capacity_factor=cf)
    close(ty, jy)
    close(taux, jaux)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        close(g, w)


def test_moe_aux_loss_and_balance():
    """tests/test_models.py's case: output shape, aux > 0 (the switch loss
    is >= coef at balance), and both equal to the reference's."""
    fields = dict(num_experts=4, top_k=2, d_expert=32, capacity_factor=2.0)
    jm, tm = JMoE(**fields), MoEConfig(**fields)
    p = jax_tree_np(jmoe.init_moe(jax.random.PRNGKey(1), 16, jm, "swiglu",
                                  jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 8, 16)))
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jm)
    out, aux = tmoe.moe_apply(tree_map(_t, p), _t(x), tm)
    assert out.shape == x.shape
    assert float(aux) > 0 and float(aux) >= tm.router_aux_coef * (1 - 1e-6)
    close(out, jout)
    close(aux, jaux)


def test_moe_gradient_same_bits_at_any_thread_count():
    """The gradient through the dispatch gather and the combine — of the
    tokens and of the expert weights — is the same bits at 1 and at 8
    threads: 4 rows of 512 tokens, top-4, so a token's gradient sums four
    slot gradients (an advanced-index gather, whose backward accumulates
    with parallel float atomics on the CPU, fails here).  The router's and
    the shared expert's weight gradients are plain GEMMs whose token-axis
    reduction the BLAS splits over threads, as every dense weight's is;
    they are not held here (bit-exact resume runs at one thread count)."""
    fields = dict(num_experts=8, top_k=4, d_expert=32, capacity_factor=1.0,
                  num_shared_experts=1, shared_d_expert=32)
    m = MoEConfig(**fields)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, 128, m, torch.float32, "cpu")
    x = torch.randn(4, 512, 128, generator=gen) + 0.2
    w = torch.randn(4, 512, 128, generator=gen)

    def grads():
        tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
        tx = x.clone().requires_grad_(True)
        y, aux = tmoe.moe_apply(tp, tx, m)
        through = [tp["w_gate"], tp["w_up"], tp["w_down"], tx]
        return torch.autograd.grad((y * w).sum() + aux, through)

    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = grads()
        torch.set_num_threads(8)
        for _ in range(3):
            assert all(torch.equal(a, b) for a, b in zip(grads(), want))
    finally:
        torch.set_num_threads(before)


# ------------------------------------------- FSDP-Norm on an MoE model --

MOE_ARCH = "dbrx-132b"


@pytest.fixture(scope="module")
def jax_moe_steps(tmp_path_factory):
    """The reference's FSDP-Norm steps of the dbrx smoke config at data=2."""
    path = str(tmp_path_factory.mktemp("fsdp_moe") / "ref.npz")
    out = run_subprocess(fsdp._JAX_STEPS % dict(
        arch=MOE_ARCH, impls=fsdp.IMPLS, steps=fsdp.STEPS, lr=fsdp.LR, metrics=fsdp.METRICS,
        snaps=fsdp.SNAPS, path=path), devices=2)
    assert "SAVED" in out
    return dict(np.load(path))


@pytest.mark.parametrize("impl", ["tree", "flat"])
def test_fsdp_norm_on_moe_matches_reference(jax_moe_steps, impl):
    """J = 2 gloo ranks, unpadded: per-step metrics at rtol 1e-5 / atol
    1e-7, parameters by tests/test_torch_fsdp_norm.py's per-entry-share
    rule."""
    cfg = get_smoke_config(MOE_ARCH)
    init_np = jax_tree_np(jbuild(jget(MOE_ARCH)).init(jax.random.PRNGKey(0)))
    traj, snaps = mesh.spawn_workers(
        fsdp._rank_steps, 2, impl, init_np, MOE_ARCH,
        fsdp._batches(arch=MOE_ARCH), timeout_s=fsdp.TIMEOUT_S)
    for t, got in enumerate(traj):
        for k in fsdp.METRICS:
            np.testing.assert_allclose(got[k], jax_moe_steps[f"{impl}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {t} {k}")
    assert traj[0]["var_l1"] > 0
    treedef = jax.tree.structure(init_np)
    for t, share, got in zip(fsdp.SNAPS, (5e-4, 2.5e-2), snaps):
        leaves = [jax_moe_steps[f"{impl}/snap{t}/{i}"]
                  for i in range(treedef.num_leaves)]
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(
            params_from_jax(jax.tree.unflatten(treedef, leaves), cfg))])
        got = np.concatenate([g.float().numpy().ravel() for g in got])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"after step {t + 1}")
        off = np.abs(got - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (t + 1, off.mean())
