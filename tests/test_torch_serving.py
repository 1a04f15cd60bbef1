"""Port serving path against the reference, float32 on the CPU: decode
attention (scalar and per-row positions, full and ring caches), the
model's `decode_step` and `prefill` with their caches, the serve-step
functions and `run_serving` (greedy tokens identical, the reference's
accounting).

Parameters come from the reference's init through `params_from_jax`,
inputs from numpy seeds.  Tolerance: logits, outputs and caches at
rtol 1e-5 with an atol of 1e-5 × the largest magnitude (the two
frameworks sum in different orders); tokens exactly."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng

from repro.configs import get_smoke_config as jget
from repro.launch.serve import run_serving as jrun_serving
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.serve_step import make_decode_step, make_prefill
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as tattn
from repro_torch.models.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves

ARCH = "llama3.2-1b"


def close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _models(seed=0, **cfg_kw):
    jcfg = jget(ARCH).replace(**cfg_kw)
    tcfg = get_smoke_config(ARCH).replace(**cfg_kw)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jmodel, tmodel, jp, params_from_jax(jax_tree_np(jp), tcfg)


def _close_caches(tcache, jcache, tcfg):
    want = cache_from_jax(jax_tree_np(jcache), tcfg)
    assert len(want) == len(tcache)
    for w, g in zip(tree_leaves(want), tree_leaves(tcache)):
        assert w.shape == g.shape and w.dtype == g.dtype
        close(g, w)


# ------------------------------------------------------- decode attention --

@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ring", [False, True])
def test_attend_decode_matches_reference(per_row, ring):
    """Several steps of one attention layer against a cache of length 6
    (a ring wraps after 6 positions), softcap on; the cache is written in
    place and returned."""
    b, d, h, kvh, hd, cache_len = 3, 32, 4, 2, 8, 6
    r = rng(1)
    p = {k: (0.2 * r.standard_normal(s)).astype(np.float32)
         for k, s in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                      ("wv", (d, kvh, hd)), ("wo", (h, hd, d)))}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    kw = dict(rope_theta=10000.0, softcap=20.0, ring=ring)
    jc = jattn.init_cache(b, cache_len, kvh, hd, jnp.float32)
    tc = tattn.init_cache(b, cache_len, kvh, hd, torch.float32, "cpu")
    tensors = (tc["k"], tc["v"])
    steps = 9 if ring else cache_len
    for i in range(steps):
        x = r.standard_normal((b, 1, d)).astype(np.float32)
        pos = (np.array([i, max(i - 2, 0), min(i + 1, steps - 1)], np.int32)
               if per_row else i)
        if per_row and not ring:
            pos = np.minimum(pos, cache_len - 1)
        jout, jc = jattn.attend_decode(
            p, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32), **kw)
        tout, tc = tattn.attend_decode(
            pt, torch.from_numpy(x), tc,
            torch.from_numpy(pos) if per_row else pos, **kw)
        close(tout, jout)
        close(tc["k"], jc["k"])
        close(tc["v"], jc["v"])
    assert tc["k"] is tensors[0] and tc["v"] is tensors[1]


# ---------------------------------------------------------- model decode --

@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_logits_and_caches_match_reference(per_row):
    jcfg, tcfg, jm, tm, jp, tp = _models(seed=2)
    b, steps = 2, 7
    toks = rng(3).integers(0, tcfg.vocab_size, (b, steps)).astype(np.int32)
    jc = jm.init_cache(b, steps + 1)
    tc = tm.init_cache(b, steps + 1, device="cpu")
    for i in range(steps):
        # per-row: the second row runs one position behind the first
        pos = np.array([i, max(i - 1, 0)], np.int32) if per_row else i
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i]),
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]),
                                torch.from_numpy(pos) if per_row else pos)
        close(tl, jl)
    _close_caches(tc, jc, tcfg)
    back = cache_to_jax(tc, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax_tree_np(jc))


def test_prefill_logits_and_caches_match_reference():
    jcfg, tcfg, jm, tm, jp, tp = _models(seed=4)
    toks = rng(5).integers(0, tcfg.vocab_size, (3, 11)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = make_prefill(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (3, tcfg.vocab_size) and torch.is_inference(tl)
    close(tl, jl)
    _close_caches(tc, jc, tcfg)


def test_prefill_continues_into_decode():
    """A prefill cache copied into a longer decode cache continues exactly
    like streaming the prompt through decode."""
    jcfg, tcfg, jm, tm, jp, tp = _models(seed=6)
    b, t = 2, 5
    toks = rng(7).integers(0, tcfg.vocab_size, (b, t + 1)).astype(np.int32)
    last, pc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :t])})
    cache = tm.init_cache(b, t + 1, device="cpu")
    for c, p in zip(cache, pc):
        c["k"][:, :t] = p["k"]
        c["v"][:, :t] = p["v"]
    streamed = tm.init_cache(b, t + 1, device="cpu")
    for i in range(t):
        sl, streamed = tm.decode_step(tp, streamed, torch.from_numpy(toks[:, i]), i)
    close(last, sl)
    a, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, t]), t)
    s, _ = tm.decode_step(tp, streamed, torch.from_numpy(toks[:, t]), t)
    close(a, s)


def test_ring_equals_full_before_wrap_and_matches_reference_after():
    """While pos < ring length, ring decode equals full-cache decode; past
    the wrap it matches the reference's ring decode."""
    jcfg, tcfg, jm, tm, jp, tp = _models(seed=5, long_context_window=4)
    b, steps = 2, 7
    toks = rng(8).integers(0, tcfg.vocab_size, (b, steps)).astype(np.int32)
    full = tm.init_cache(b, steps, device="cpu")
    ring = tm.init_cache(b, steps, ring=True, device="cpu")
    assert ring[0]["k"].shape[1] == 4
    jring = jm.init_cache(b, steps, ring=True)
    step = make_decode_step(tm, ring=True)
    for i in range(steps):
        t = torch.from_numpy(toks[:, i])
        lf, full = tm.decode_step(tp, full, t, i)
        lr, ring = step(tp, ring, t, i)
        jl, jring = jm.decode_step(jp, jring, jnp.asarray(toks[:, i]),
                                   jnp.int32(i), ring=True)
        if i < 4:
            np.testing.assert_allclose(np32(lr), np32(lf), rtol=1e-5, atol=1e-5)
        close(lr, jl)
    _close_caches(ring, jring, tcfg)


def test_device_defaults_to_the_card(monkeypatch):
    """With no device named and no card, the model API raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config(ARCH))
    for call in (lambda: model.init(0), lambda: model.init_cache(1, 4),
                 lambda: serve_mod.run_serving(ARCH, batch=1, prompt_len=2,
                                               gen_len=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------- run_serving --

def _port_serving(seed=0, **kw):
    jcfg, tcfg, jm, tm, jp, tp = _models(seed=seed)
    return serve_mod.run_serving(ARCH, smoke=True, seed=seed, params=tp, **kw)


@pytest.mark.parametrize("batch,prompt_len,gen_len", [(2, 8, 8), (3, 5, 6)])
def test_run_serving_tokens_identical_to_reference(batch, prompt_len, gen_len):
    """The reference's `run_serving` draws its parameters from PRNGKey(seed) and its
    prompts from numpy's default_rng(seed); the port gets the same
    parameters converted and draws the same prompts."""
    kw = dict(batch=batch, prompt_len=prompt_len, gen_len=gen_len)
    want = jrun_serving(ARCH, smoke=True, seed=0, **kw)
    got = _port_serving(seed=0, **kw)
    assert got["tokens"].shape == (batch, gen_len)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert set(got) == set(want)


def test_serving_launchers_refuse_device_with_params():
    """Given params serve on their own device; naming another one too is an
    error, not a silent override."""
    params = build_model(get_smoke_config(ARCH)).init(0, "cpu")
    for run in (serve_mod.run_serving, serve_mod.run_continuous_serving):
        with pytest.raises(ValueError, match="not both"):
            run(ARCH, params=params, device="cpu")


def test_run_serving_accounting():
    batch, gen_len = 2, 8
    res = _port_serving(batch=batch, prompt_len=4, gen_len=gen_len)
    assert res["decode_tokens_timed"] == batch * (gen_len - 1)
    assert res["decode_tok_per_s"] == pytest.approx(
        res["decode_tokens_timed"] / res["decode_s"])


def test_run_serving_gen_len_one():
    res = _port_serving(batch=2, prompt_len=4, gen_len=1)
    assert res["tokens"].shape == (2, 1)
    assert res["decode_tokens_timed"] == 0
    assert res["decode_tok_per_s"] == 0.0


def test_run_serving_syncs_before_every_clock_read(monkeypatch):
    """The device is synchronised before each phase clock is read, so no
    queued work leaks from one phase into the other's time."""
    calls = []
    real_sync, real_time = serve_mod._sync, serve_mod.time.time
    monkeypatch.setattr(serve_mod, "_sync",
                        lambda d: (calls.append("sync"), real_sync(d)))
    monkeypatch.setattr(serve_mod, "time", types.SimpleNamespace(
        time=lambda: (calls.append("clock"), real_time())[1]))
    _port_serving(batch=1, prompt_len=2, gen_len=2)
    clocks = [i for i, c in enumerate(calls) if c == "clock"]
    assert len(clocks) == 4
    assert all(calls[i - 1] == "sync" for i in clocks)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--batch", "1", "--prompt-len", "3",
                    "--gen-len", "2"])
    assert "tok/s" in capsys.readouterr().out
