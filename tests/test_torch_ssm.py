"""The port's recurrent mixers against the reference's, float32 on the CPU:
Mamba-2's SSD (`models/ssd.py`: the chunked dual form over a full
sequence, and the one-step recurrence) and Griffin's RG-LRU
(`models/rglru.py`: the block, its log-depth scan against the reference's
`associative_scan`, and the one-step recurrence), on the smoke configs'
widths, from parameters and inputs drawn with numpy from a seed.  Then
recurrentgemma's smoke config with one RG-LRU prefix layer
(`prefix_blocks`, which the registered smoke config leaves out): loss and
gradients, and decode caches converted both ways.  Last, FSDP-Norm at
J = 2 gloo ranks on the mamba2 smoke config in flat residency and the
recurrentgemma one in tree residency, against the reference's steps on 2
forced host devices (tests/test_torch_fsdp_norm.py's harness and
tolerances).

Tolerance: rtol 1e-5 with an atol of 1e-5 x the largest magnitude (the
frameworks sum in different orders); decode states likewise.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_fsdp_norm as fsdp
from conftest import run_subprocess
from test_torch_helpers import jax_tree_np, np32, rng
from test_torch_model import _compare

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _params(init, cfg, sub, seed):
    """A mixer's parameters from the reference's init, numpy leaves, and
    the same as torch tensors."""
    jp = jax_tree_np(init(jax.random.PRNGKey(seed), cfg.d_model, sub, jnp.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed, scale=1.0):
    return (scale * rng(seed).standard_normal(shape)).astype(np.float32)


def _ssd_params(cfg, seed):
    """SSD parameters where the state-space path carries the output: at
    the init's convolution taps (std 0.02) B, C and x after the
    convolution are ~1e-2 and the skip path d_skip * x outweighs the
    recurrence 1e4-fold, below any tolerance; so the taps are drawn at std
    0.5 and the skip is zero."""
    jp, _ = _params(jssd.init_ssd, cfg, cfg.ssm, seed)
    jp["conv_w"] = _x(jp["conv_w"].shape, seed=seed + 100, scale=0.5)
    jp["d_skip"] = np.zeros_like(jp["d_skip"])
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("t", [8, 40])
def test_ssd_block_matches_reference(t):
    """One chunk (t 8) and five (t 40) of the smoke config's chunk 8, the
    state-space path carrying the output (`_ssd_params`)."""
    cfg = jget("mamba2-370m")
    jp, tp = _ssd_params(cfg, seed=1)
    x = _x((2, t, cfg.d_model), seed=2)
    want = jssd.ssd_block(jp, jnp.asarray(x), cfg.ssm)
    got = tssd.ssd_block(tp, torch.from_numpy(x), get_smoke_config("mamba2-370m").ssm)
    close(got, want)


def test_ssd_block_refuses_a_partial_chunk():
    cfg = get_smoke_config("mamba2-370m")
    tp = tssd.init_ssd(torch.Generator().manual_seed(0), cfg.d_model, cfg.ssm,
                       torch.float32, "cpu")
    with pytest.raises(ValueError, match="divisible by chunk"):
        tssd.ssd_block(tp, torch.zeros(1, 12, cfg.d_model), cfg.ssm)


def test_ssd_decode_matches_reference_and_the_chunked_form():
    """12 steps of the recurrence from a random state: outputs and the SSM
    and convolution states equal the reference's step by step; from a zero
    state, the first 8 outputs equal the chunked form's over the same 8
    inputs."""
    cfg = jget("mamba2-370m")
    tcfg = get_smoke_config("mamba2-370m")
    jp, tp = _ssd_params(cfg, seed=3)
    b = 2
    jstate = jax_tree_np(jssd.init_ssd_state(b, cfg.d_model, cfg.ssm, jnp.float32))
    jstate = {k: v + _x(v.shape, seed=4 + i, scale=0.1)
              for i, (k, v) in enumerate(sorted(jstate.items()))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    xs = _x((b, 12, cfg.d_model), seed=6)
    for i in range(12):
        jy, jstate = jssd.ssd_decode(jp, jnp.asarray(xs[:, i:i + 1]), jstate, cfg.ssm)
        ty, tstate = tssd.ssd_decode(tp, torch.from_numpy(xs[:, i:i + 1]), tstate,
                                     tcfg.ssm)
        close(ty, jy)
        for k in jstate:
            close(tstate[k], jstate[k])
    zero = tssd.init_ssd_state(b, cfg.d_model, tcfg.ssm, torch.float32, "cpu")
    steps = [tssd.ssd_decode(tp, torch.from_numpy(xs[:, i:i + 1]), zero, tcfg.ssm)[0]
             for i in range(8)]
    close(torch.cat(steps, dim=1), tssd.ssd_block(tp, torch.from_numpy(xs[:, :8]),
                                                  tcfg.ssm))


@pytest.mark.parametrize("t", [1, 5, 37, 1000])
def test_rglru_scan_matches_associative_scan(t):
    """The log-depth scan against the reference's `associative_scan`, and
    against the t-step recurrence, with decays in (0, 1) as the gates make
    them."""
    r = rng(t)
    a = r.uniform(0.5, 1.0, (2, t, 16)).astype(np.float32)
    bx = r.standard_normal((2, t, 16)).astype(np.float32)
    got = trglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    close(got, jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(bx)))
    h, loop = np.zeros((2, 16), np.float32), []
    for i in range(t):
        h = a[:, i] * h + bx[:, i]
        loop.append(h)
    close(got, np.stack(loop, axis=1))


def test_rglru_block_matches_reference():
    cfg = jget("recurrentgemma-9b")
    jp, tp = _params(jrglru.init_rglru, cfg, cfg.rglru, seed=7)
    x = _x((2, 37, cfg.d_model), seed=8)
    want = jrglru.rglru_block(jp, jnp.asarray(x), cfg.rglru)
    got = trglru.rglru_block(tp, torch.from_numpy(x),
                             get_smoke_config("recurrentgemma-9b").rglru)
    close(got, want)


def test_rglru_decode_matches_reference_and_the_block():
    """12 recurrence steps from a random state equal the reference's
    (outputs, h and the convolution ring); from a zero state the steps
    equal the block over the same inputs."""
    cfg = jget("recurrentgemma-9b")
    tcfg = get_smoke_config("recurrentgemma-9b")
    jp, tp = _params(jrglru.init_rglru, cfg, cfg.rglru, seed=9)
    b = 2
    jstate = jax_tree_np(jrglru.init_rglru_state(b, cfg.d_model, cfg.rglru, jnp.float32))
    jstate = {k: v + _x(v.shape, seed=10 + i, scale=0.1)
              for i, (k, v) in enumerate(sorted(jstate.items()))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    xs = _x((b, 12, cfg.d_model), seed=12)
    for i in range(12):
        jy, jstate = jrglru.rglru_decode(jp, jnp.asarray(xs[:, i:i + 1]), jstate,
                                         cfg.rglru)
        ty, tstate = trglru.rglru_decode(tp, torch.from_numpy(xs[:, i:i + 1]), tstate,
                                         tcfg.rglru)
        close(ty, jy)
        for k in jstate:
            close(tstate[k], jstate[k])
    zero = trglru.init_rglru_state(b, cfg.d_model, tcfg.rglru, torch.float32, "cpu")
    steps = [trglru.rglru_decode(tp, torch.from_numpy(xs[:, i:i + 1]), zero,
                                 tcfg.rglru)[0] for i in range(12)]
    close(torch.cat(steps, dim=1), trglru.rglru_block(tp, torch.from_numpy(xs),
                                                      tcfg.rglru))


PREFIXED = dict(prefix_pattern=("rglru",), num_layers=4)


def test_recurrentgemma_prefix_layer_loss_and_grads():
    """recurrentgemma smoke with an RG-LRU prefix layer before its
    (rglru, rglru, local) repeat: loss and every gradient leaf, the
    reference's `prefix_blocks` converted to the port's first layer."""
    _compare("recurrentgemma-9b", b=2, t=24, seed=13, **PREFIXED)


def test_recurrentgemma_prefix_layer_decode_caches():
    """Ten decode steps of the same config: logits and every layer's cache
    (the prefix layer's RG-LRU state first) equal the reference's, and the
    port's cache converts to the reference's tree and back unchanged."""
    jcfg = jget("recurrentgemma-9b").replace(**PREFIXED)
    tcfg = get_smoke_config("recurrentgemma-9b").replace(**PREFIXED)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(14))
    tp = params_from_jax(jax_tree_np(jp), tcfg)
    assert len(tp["layers"]) == 4 and "rec" in tp["layers"][0]
    b, t = 2, 10
    toks = rng(15).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t, device="cpu")
    jstep = jax.jit(jm.decode_step)
    for i in range(t):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i]), jnp.int32(i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i)
        close(tl, jl)
    want = cache_from_jax(jax_tree_np(jc), tcfg)
    assert sorted(tc[0]) == ["conv", "h"]
    for w, g in zip(want, tc, strict=True):
        assert sorted(w) == sorted(g)
        for k in w:
            close(g[k], w[k])
    back = cache_to_jax(tc, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax_tree_np(jc))
    again = cache_from_jax(back, tcfg)
    for w, g in zip(again, tc):
        assert all(torch.equal(w[k], g[k]) for k in g)


# one residency each (parameters and statistics alike), so that both are
# held and the reference runs each architecture's steps once
FSDP_CASES = [("mamba2-370m", "flat"), ("recurrentgemma-9b", "tree")]


@pytest.fixture(scope="module")
def jax_fsdp_steps(tmp_path_factory):
    """The reference's FSDP-Norm steps at data=2 for each of FSDP_CASES,
    in its residency (one subprocess each, run side by side)."""
    def run(arch, impl):
        path = str(tmp_path_factory.mktemp("fsdp_ssm") / "ref.npz")
        log = run_subprocess(fsdp._JAX_STEPS % dict(
            arch=arch, impls=(impl,), steps=fsdp.STEPS, lr=fsdp.LR,
            metrics=fsdp.METRICS, snaps=fsdp.SNAPS, path=path), devices=2)
        assert "SAVED" in log
        return arch, dict(np.load(path))

    with ThreadPoolExecutor(len(FSDP_CASES)) as pool:
        return dict(pool.map(lambda case: run(*case), FSDP_CASES))


@pytest.mark.parametrize("arch,impl", FSDP_CASES)
def test_fsdp_norm_matches_reference(jax_fsdp_steps, arch, impl):
    """J = 2 gloo ranks, unpadded, 5 steps: per-step metrics at rtol 1e-5 /
    atol 1e-7, parameters by the per-entry-share rule."""
    want_steps = jax_fsdp_steps[arch]
    cfg = get_smoke_config(arch)
    init_np = jax_tree_np(jbuild(jget(arch)).init(jax.random.PRNGKey(0)))
    traj, snaps = mesh.spawn_workers(
        fsdp._rank_steps, 2, impl, init_np, arch, fsdp._batches(arch=arch),
        timeout_s=fsdp.TIMEOUT_S)
    for t, got in enumerate(traj):
        for k in fsdp.METRICS:
            np.testing.assert_allclose(got[k], want_steps[f"{impl}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {t} {k}")
    assert traj[0]["var_l1"] > 0
    treedef = jax.tree.structure(init_np)
    for t, share, got in zip(fsdp.SNAPS, (5e-4, 2.5e-2), snaps):
        leaves = [want_steps[f"{impl}/snap{t}/{i}"] for i in range(treedef.num_leaves)]
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(
            params_from_jax(jax.tree.unflatten(treedef, leaves), cfg))])
        got = np.concatenate([g.float().numpy().ravel() for g in got])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"after step {t + 1}")
        off = np.abs(got - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (t + 1, off.mean())
