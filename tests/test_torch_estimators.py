"""The exact norm-test estimators (eq. 3 `per_sample_norm_test`, eq. 4
`exact_variance_test_holds`) and the five functions of `core/theory.py`
against the reference's, on the same seeded numpy inputs, with the cases
of tests/test_norm_test.py and tests/test_theory.py, and eq. 3 through
the smoke decoder.

Tolerances: floats at rtol 1e-5 (f32 sums in another order); booleans,
the minimal batch (an integer after ceil) and `adam_beta_condition`'s
dict exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import np32, rng

from repro.configs import get_smoke_config as jget
from repro.core import norm_test as jnt
from repro.core import theory as jth
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.core import norm_test as tnt
from repro_torch.core import theory as tth
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def quad_loss_j(params, example):
    return jnp.sum((params["w"] - example) ** 2)


def quad_loss_t(params, example):
    return torch.sum((params["w"] - example) ** 2)


def mlp_loss_j(params, ex):
    h = jnp.tanh(ex["x"] @ params["l1"]["w"] + params["l1"]["b"])
    return jnp.sum((h @ params["l2"][0] - ex["y"]) ** 2)


def mlp_loss_t(params, ex):
    h = torch.tanh(ex["x"] @ params["l1"]["w"] + params["l1"]["b"])
    return torch.sum((h @ params["l2"][0] - ex["y"]) ** 2)


def _mlp_inputs(seed):
    r = rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    params = {"l1": {"w": f(5, 7), "b": f(7)}, "l2": [f(7, 3)]}
    batch = {"x": f(8, 5), "y": f(8, 3)}
    return params, batch


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


KEYS = ("T", "lhs_over_b", "var_l1", "grad_sqnorm")


@pytest.mark.parametrize("case", ["quad", "mlp"])
@pytest.mark.parametrize("eta", [0.1, 0.5])
def test_per_sample_norm_test_matches_reference(case, eta):
    if case == "quad":
        r = rng(0)
        params = {"w": r.standard_normal(5).astype(np.float32)}
        batch = r.standard_normal((8, 5)).astype(np.float32)
        losses = quad_loss_j, quad_loss_t
    else:
        params, batch = _mlp_inputs(1)
        losses = mlp_loss_j, mlp_loss_t
    (jp, tp), (jb, tb) = _both(params), _both(batch)
    want = jnt.per_sample_norm_test(losses[0], jp, jb, eta)
    got = tnt.per_sample_norm_test(losses[1], tp, tb, eta)
    assert sorted(got) == sorted(want)
    for k in KEYS:
        np.testing.assert_allclose(np32(got[k]), np32(want[k]), rtol=1e-5,
                                   err_msg=k)
    for a, b in zip(tree_leaves(got["grad"]), jax.tree.leaves(want["grad"])):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-7)


def test_per_sample_norm_test_matches_manual():
    """tests/test_norm_test.py's hand-computed case."""
    r = rng(0)
    w = r.standard_normal(5).astype(np.float32)
    xs = r.standard_normal((8, 5)).astype(np.float32)
    res = tnt.per_sample_norm_test(quad_loss_t, {"w": torch.from_numpy(w)},
                                   torch.from_numpy(xs), eta=0.5)
    grads = np.stack([2 * (w - x) for x in xs])
    gmean = grads.mean(0)
    var_l1 = ((grads - gmean) ** 2).sum() / (len(xs) - 1)
    np.testing.assert_allclose(float(res["var_l1"]), var_l1, rtol=1e-5)
    np.testing.assert_allclose(float(res["grad_sqnorm"]), (gmean ** 2).sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(res["T"]), var_l1 / (0.25 * (gmean ** 2).sum() + 1e-30), rtol=1e-5)


def _per_sample(kind, seed):
    r = rng(seed)
    if kind == "zero_noise":       # identical per-sample grads
        return {"w": np.ones((4, 3), np.float32)}
    if kind == "pure_noise":       # zero-mean grads
        return {"w": np.asarray([[1.0, -1.0], [-1.0, 1.0]], np.float32)}
    mu = r.standard_normal(6).astype(np.float32)
    noise = {"low": 0.05, "high": 3.0}[kind]
    return {"a": (mu[None] + noise * r.standard_normal((16, 6))).astype(np.float32),
            "b": [(0.5 + noise * r.standard_normal((16, 2, 2))).astype(np.float32)]}


@pytest.mark.parametrize("kind", ["zero_noise", "pure_noise", "low", "high"])
@pytest.mark.parametrize("eta", [0.01, 0.3, 0.9])
def test_exact_variance_test_matches_reference(kind, eta):
    jg, tg = _both(_per_sample(kind, 3))
    want = bool(jnt.exact_variance_test_holds(jg, eta))
    got = tnt.exact_variance_test_holds(tg, eta)
    assert got.dtype == torch.bool and bool(got) == want
    if kind == "zero_noise":
        assert want                 # holds for any eta
    if kind == "pure_noise" and eta == 0.9:
        assert not want             # must fail


def _gaussian(seed, n, d, noise):
    """tests/test_theory.py's per-sample gradients (mu + noise), from numpy."""
    r = rng(seed)
    mu = r.standard_normal(d).astype(np.float32)
    return {"w": (mu[None] + noise * r.standard_normal((n, d))).astype(np.float32)}


@pytest.mark.parametrize("n,d,noise,eta,b", [
    (4096, 32, 0.05, 0.5, 64), (8192, 16, 0.3, 0.4, 8), (256, 8, 1.0, 0.2, 4)])
def test_theory_matches_reference(n, d, noise, eta, b):
    jg, tg = _both(_gaussian(n + d, n, d, noise))
    for a, w in zip(tth.per_coordinate_stats(tg), jth.per_coordinate_stats(jg)):
        np.testing.assert_allclose(np32(a), np32(w), rtol=1e-5, atol=1e-7)
    assert (bool(tth.coordinate_norm_test_holds(tg, eta, b))
            == bool(jth.coordinate_norm_test_holds(jg, eta, b)))
    np.testing.assert_allclose(float(tth.esg_constant(tg, b)),
                               float(jth.esg_constant(jg, b)), rtol=1e-5)
    b_star = tth.minimal_batch_for_coordinate_test(tg, eta)
    assert float(b_star) == float(jth.minimal_batch_for_coordinate_test(jg, eta))
    # Prop. 1: the coordinate test at b* holds, and then E-SG <= 1 + eta^2
    b_star = int(b_star)
    assert bool(tth.coordinate_norm_test_holds(tg, eta, b_star))
    assert float(tth.esg_constant(tg, b_star)) <= 1 + eta**2 + 1e-6
    if b_star > 1:
        assert not bool(tth.coordinate_norm_test_holds(tg, eta,
                                                       max(b_star // 4, 1)))


@pytest.mark.parametrize("beta2", [0.9, 0.95, 0.99, 0.999, 0.99999])
@pytest.mark.parametrize("eta", [0.01, 0.2, 0.5, 0.9])
def test_adam_beta_condition_matches_reference(beta2, eta):
    for beta1 in (0.5, 0.9):
        assert (tth.adam_beta_condition(beta1, beta2, eta)
                == jth.adam_beta_condition(beta1, beta2, eta))
    # noisier gradients -> stricter beta1 (tests/test_theory.py's property)
    assert (tth.adam_beta_condition(0.5, beta2, eta + 0.05)["beta1_bound"]
            <= tth.adam_beta_condition(0.5, beta2, eta)["beta1_bound"] + 1e-12)


def test_adam_beta_condition_paper_defaults():
    """The paper's own training betas (0.9, 0.95) violate Theorem 1's
    sufficient condition; it holds for beta2 = 0.999."""
    assert not tth.adam_beta_condition(0.9, 0.95, eta=0.2)["holds"]
    assert tth.adam_beta_condition(0.9, 0.999, eta=0.2)["holds"]


def test_per_sample_norm_test_on_the_smoke_model():
    """Eq. 3 on the microllama smoke decoder (b = 8, one sequence an
    example), from the reference's initial parameters: the port's
    vmap-of-grad through its model against the reference's."""
    jm = jbuild(jget("microllama-300m"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config("microllama-300m"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg)
    toks = rng(5).integers(0, tm.cfg.vocab_size, (8, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb, tb = _both(batch)
    want = jnt.per_sample_norm_test(
        lambda p, ex: jm.loss(p, jax.tree.map(lambda x: x[None], ex))[0],
        jp, jb, 0.2)
    got = tnt.per_sample_norm_test(
        lambda p, ex: tm.loss(p, {k: v[None] for k, v in ex.items()})[0],
        tp, tb, 0.2)
    for k in KEYS:
        np.testing.assert_allclose(np32(got[k]), np32(want[k]), rtol=1e-5,
                                   err_msg=k)
