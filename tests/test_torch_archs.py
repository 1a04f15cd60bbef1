"""The architectures beyond the Llama family, the port against the
reference, float32 on the CPU, on their smoke configs: gemma2 (local/global
alternation, softcaps, post-norms, scaled embeddings), nemotron-4
(LayerNorm, squared ReLU), phi3-mini (head dim 96, MHA), dbrx (MoE),
deepseek-v2 (a dense MLA prefix layer, then MLA + MoE with a shared
expert), mamba2 (SSD, no attention), recurrentgemma (RG-LRU and local
attention), whisper (encoder-decoder over stub audio frames, sinusoidal
positions) and internvl2 (a stub vision patch prefix).

Per family: the config field for field and its parameter count; the
forward-only kernel launches the card expects (every registered config); the
loss and every gradient leaf (tests/test_torch_model.py's `_compare`:
rtol 1e-5, atol 1e-5 × the leaf's largest magnitude); prefill logits and
caches; decode logits and caches step by step against the reference, and
against the port's own teacher-forced forward; ring decode past the cache
length (an encoder-decoder's cross caches filled from the same frames on
both sides; a vision config's decode streams text only, so its teacher
forcing is `tests/test_torch_encdec.py`'s, through its prefix).  Then
greedy serving (fixed batch, and the continuous-batching engine) for
gemma2 with prompts longer than its window, deepseek-v2 and the four
configs above, tokens exactly; ACCUM-NORM's loop on dbrx, deepseek-v2,
mamba2 and recurrentgemma (batch trajectory and controller plan exactly,
losses to rtol 1e-5).

Tolerance on logits and caches: rtol 1e-5 with an atol of 1e-5 × the
largest magnitude (the frameworks sum in different orders)."""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng
from test_torch_model import _batch, _compare

from repro.configs import get_config as jget_full, get_smoke_config as jget
from repro.distributed.serve_engine import ServeEngine as JServeEngine
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import run_serving as jrun_serving
from repro.launch.train import TrainJob as JJob, run_training as jrun
from repro.models import build_model as jbuild
from repro.models.attention import precompute_cross_kv as jcross_kv
from repro.models.transformer import encode as jencode
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.distributed.serve_engine import ServeEngine
from repro_torch.distributed.serve_step import make_prefill
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models.convert import cache_from_jax, cache_to_jax, params_from_jax
from repro_torch.models import attention, blocks, mla, norms, transformer
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_kinds
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ARCH_LAYERS, fill_cross_cache, forward_kernel_launches  # noqa: E402

ARCHS = ["gemma2-27b", "nemotron-4-15b", "phi3-mini-3.8b", "dbrx-132b",
         "deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b", "whisper-base",
         "internvl2-1b"]
MOE_ARCHS = ["dbrx-132b", "deepseek-v2-236b"]
# a full-sequence forward of mamba2 takes a multiple of its chunk (8)
PREFILL_LEN = {"mamba2-370m": 24}
ATTN_CACHE = ("k", "v", "c_kv", "k_rope")


def close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _models(arch, seed=0, **cfg_kw):
    jcfg = jget(arch).replace(**cfg_kw)
    tcfg = get_smoke_config(arch).replace(**cfg_kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return tcfg, jm, tm, jp, params_from_jax(jax_tree_np(jp), tcfg)


def _close_caches(tcache, jcache, tcfg, extra=()):
    """Every layer cache of the reference's equal to the port's (None where
    the reference's prefill collects none); the port's may hold the keys
    `extra` beside them."""
    want = cache_from_jax(jax_tree_np(jcache), tcfg)
    assert len(want) == len(tcache)
    for w, g in zip(want, tcache):
        if w is None:
            assert g is None
            continue
        assert sorted(w) == sorted(k for k in g if k not in extra)
        for k in w:
            assert w[k].shape == g[k].shape and w[k].dtype == g[k].dtype
            close(g[k], w[k])


def _frontend(cfg, b, seed):
    """The numpy stub-frontend inputs of `cfg` for b rows ({} for none)."""
    return {k: v for k, v in _batch(cfg, b, 1, seed).items()
            if k in ("frames", "patch_embeds")}


def _fill_jax_cross(jm, jp, jc, frames):
    """The reference's decode cache with its cross k and v over `frames`,
    built as `tests/test_serving.py` builds it."""
    cfg = jm.cfg
    enc = jencode(jp, jnp.asarray(frames).astype(cfg.act_dtype), cfg)
    jc = dict(jc)
    jc["cross_prefix"] = [jcross_kv(p["cross_attn"], enc)
                          for p in jp.get("prefix_blocks", [])]
    jc["cross_scanned"] = [
        jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[jcross_kv(jax.tree.map(lambda a: a[r], bp)["cross_attn"], enc)
                       for r in range(cfg.num_repeats)])
        for bp in jp["blocks"]]
    return jc


def _tokens(cfg, b, t, seed):
    return rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _reference_fields(port, ref) -> dict:
    """The port's config as a dict of the reference's fields.  A field the
    reference lacks (`MoEConfig`'s held share and DeepSeek-V2 routing
    options) must be at its default, the reference's behaviour."""
    out = {}
    for f in dataclasses.fields(port):
        v = getattr(port, f.name)
        if not hasattr(ref, f.name):
            assert v == f.default, f.name
            continue
        r = getattr(ref, f.name)
        out[f.name] = (_reference_fields(v, r) if dataclasses.is_dataclass(v)
                       and dataclasses.is_dataclass(r) else v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_equal_reference(arch):
    """CONFIG and smoke_config() field for field (the port's extra fields at
    their defaults), the parameter count (total and active) at the
    published depth and at chip_smoke.py's, and the port's own init has the
    reference's leaves, shapes and dtypes."""
    for port, ref in ((get_config(arch), jget_full(arch)),
                      (get_smoke_config(arch), jget(arch))):
        assert _reference_fields(port, ref) == dataclasses.asdict(ref)
    full = get_config(arch)
    for n in {full.num_layers, ARCH_LAYERS.get(arch, 1)}:   # chip_smoke's depth too
        port, ref = full.replace(num_layers=n), jget_full(arch).replace(num_layers=n)
        assert port.param_count() == ref.param_count(), n
        assert port.param_count(active_only=True) == ref.param_count(active_only=True), n
    tcfg, _, tm, _, tp = _models(arch)
    own = tm.init(0, "cpu")
    assert [(x.shape, x.dtype) for x in tree_leaves(own)] == \
        [(x.shape, x.dtype) for x in tree_leaves(tp)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_kernel_launches_count_each_kernel_call(arch, monkeypatch):
    """`forward_kernel_launches` — what chip_smoke.py and the card tests
    expect a forward with grad mode off to launch — equals the RMSNorm,
    attention and dense-projection calls a forward makes, counted on the
    CPU where the same calls reach the kernels' plain versions (every
    `ops.dense` call the einsum, counted once)."""
    from repro_torch.kernels import ops
    calls = {"flash_attention": 0, "rmsnorm": 0}
    real_norm, real_sdpa = norms.apply_norm, attention._sdpa

    def norm(p, x, kind, eps=1e-6):
        calls["rmsnorm"] += kind == "rmsnorm"
        return real_norm(p, x, kind, eps)

    def sdpa(*a, **kw):
        calls["flash_attention"] += 1
        return real_sdpa(*a, **kw)

    for mod in (blocks, mla, transformer):
        monkeypatch.setattr(mod, "apply_norm", norm)
    monkeypatch.setattr(attention, "_sdpa", sdpa)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 8, seed=0).items()}
    params = model.init(0, "cpu")
    before = ops.call_counts()["dense"]
    with torch.no_grad():
        model.loss(params, batch)
    calls["dense"] = ops.call_counts()["dense"] - before
    assert calls == forward_kernel_launches(cfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_kernel_launches_count_the_dense_products_a_prefill_routes(
        arch, monkeypatch):
    """`forward_kernel_launches(cfg, prefill_batch=b)["dense"]`, what the
    card launches in a prefill, equals the `ops.dense` calls of a prefill
    with at least `MIN_ROWS` rows (the rows the kernel's rule reads), and
    of a loss forward all of them: 4 prompts of 64 tokens (whisper's smoke
    encoder 4 x 16 frames), so that only a prefill's head (one row a
    prompt) falls under the rule."""
    from repro_torch.kernels import dense as dense_mod
    from repro_torch.kernels import ops
    rows = []
    monkeypatch.setattr(ops, "_dense_routed",
                        lambda x, w, n: rows.append(n) or False)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 64, seed=0).items()}
    with torch.no_grad():
        model.loss(params, batch)
        loss_rows, rows[:] = list(rows), []
        model.prefill(params, {k: v for k, v in batch.items() if k != "labels"})
    routed = lambda ns: sum(n >= dense_mod.MIN_ROWS for n in ns)
    assert routed(loss_rows) == len(loss_rows) == forward_kernel_launches(cfg)["dense"]
    assert routed(rows) == forward_kernel_launches(cfg, prefill_batch=4)["dense"]
    assert len(rows) == routed(rows) + 1                  # the head's 4 rows


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    _compare(arch, b=2, t=24, seed=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch):
    """Last-token logits and every cache the reference's prefill collects
    (a vision prefix's positions included); an encoder-decoder's port
    caches also hold its cross k and v, held by
    tests/test_torch_encdec.py."""
    tcfg, jm, tm, jp, tp = _models(arch, seed=4)
    batch = {"tokens": _tokens(tcfg, 3, PREFILL_LEN.get(arch, 20), seed=5),
             **_frontend(tcfg, 3, seed=6)}
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = make_prefill(tm)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(tl, jl)
    _close_caches(tc, jc, tcfg, extra=("cross_k", "cross_v"))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_teacher_forcing(arch):
    """24 tokens streamed through decode, the second row one position
    behind (per-row positions; gemma2's and recurrentgemma's windows are
    16, so their local layers' rings wrap): logits and caches equal the
    reference's step by step, and the first row's logits equal the port's
    teacher-forced forward.  An encoder-decoder's cross caches hold k and v
    over the same frames on both sides; a vision config streams text only,
    so it has no teacher-forced counterpart here."""
    tcfg, jm, tm, jp, tp = _models(arch, seed=2)
    b, t = 2, 24
    toks = _tokens(tcfg, b, t, seed=3)
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t, device="cpu")
    front = _frontend(tcfg, b, seed=4)
    if "frames" in front:
        jc = _fill_jax_cross(jm, jp, jc, front["frames"])
        fill_cross_cache(tp, tc, torch.from_numpy(front["frames"]), tcfg)
    dec = []
    jstep = jax.jit(jm.decode_step)        # one trace for the 24 steps
    for i in range(t):
        pos = np.array([i, max(i - 1, 0)], np.int32)
        tok = toks[:, i].copy()
        tok[1] = toks[1, max(i - 1, 0)]
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        close(tl, jl)
        dec.append(tl[0])
    _close_caches(tc, jc, tcfg)
    back = cache_to_jax(tc, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax_tree_np(jc))
    if "patch_embeds" in front:
        return
    with torch.no_grad():
        full = tm.logits(tp, {"tokens": torch.from_numpy(toks[:1]),
                              **{k: torch.from_numpy(v[:1]) for k, v in front.items()}})[0]
    close(torch.stack(dec), full)


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_decode_past_the_cache_length(arch):
    """Ring caches of length 8 (`long_context_window`; gemma2's local
    layers keep their window of 16), 13 steps at a
    scalar position — past the wrap — then one at position 37: logits and
    caches equal the reference's, and finite."""
    tcfg, jm, tm, jp, tp = _models(arch, seed=6, long_context_window=8)
    b, steps = 2, 13
    toks = _tokens(tcfg, b, steps + 1, seed=7)
    jc, tc = jm.init_cache(b, 64, ring=True), tm.init_cache(b, 64, ring=True,
                                                             device="cpu")
    jstep = jax.jit(jm.decode_step, static_argnames="ring")
    for i, pos in enumerate(list(range(steps)) + [37]):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i]), jnp.int32(pos),
                                ring=True)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), pos,
                                ring=True)
        close(tl, jl)
        assert torch.isfinite(tl).all()
    for kind, layer in zip(layer_kinds(tcfg), tc):      # local: its window
        want = tcfg.sliding_window if kind == "local" else 8
        assert all(x.shape[1] == want for k, x in layer.items()
                   if k in ATTN_CACHE), kind
    _close_caches(tc, jc, tcfg)


# ------------------------------------------------------------- serving --

SERVE_ARCHS = ["gemma2-27b", "deepseek-v2-236b", "mamba2-370m",
               "recurrentgemma-9b", "whisper-base", "internvl2-1b"]


def _prefix(arch) -> int:
    """A vision config's prefix tokens, which its prompt budget holds."""
    cfg = get_smoke_config(arch)
    return cfg.frontend.num_prefix_tokens if cfg.frontend.kind == "vision_stub" else 0


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_run_serving_tokens_identical_to_reference(arch):
    """Prompts of 18 text tokens (beyond gemma2's and recurrentgemma's
    windows of 16), 6 generated: the port gets the reference's
    PRNGKey(0) parameters, converted, and draws the same prompts (a vision
    config's budget also holds its prefix tokens)."""
    kw = dict(batch=2, prompt_len=18 + _prefix(arch), gen_len=6)
    want = jrun_serving(arch, smoke=True, seed=0, **kw)
    tcfg, _, _, _, tp = _models(arch)
    got = serve_mod.run_serving(arch, smoke=True, seed=0, params=tp, **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_engine_tokens_identical_to_reference(arch):
    """Five requests of 14-21 prompt tokens joining, leaving and compacting
    a 4-slot resident cache (gemma2's local layers hold 16-slot rings):
    every request's greedy tokens and the engine's bookkeeping equal the
    reference engine's."""
    tcfg, jm, tm, jp, tp = _models(arch, seed=7)
    kw = dict(max_slots=4, cache_len=28)
    jeng = JServeEngine(jm, jp, make_host_mesh(1, 1), **kw)
    teng = ServeEngine(tm, tp, **kw)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, tcfg.vocab_size, size=(r.randint(14, 22),))
               .astype(np.int32) for _ in range(5)]
    news = [4, 2, 6, 3, 5]
    jr = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    tr = [teng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    assert len(jeng.run_until_drained()) == len(teng.run_until_drained()) == 5
    for a, b in zip(tr, jr):
        assert a.generated == b.generated, a.rid
    keys = ("steps", "requests_completed", "tokens_generated", "prompt_tokens",
            "slot_resets", "slot_moves", "rung_transitions", "padding_waste")
    td, jd = teng.stats.as_dict(), jeng.stats.as_dict()
    assert {k: td[k] for k in keys} == {k: jd[k] for k in keys}
    assert td["slot_moves"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_arch(arch, capsys):
    serve_mod.main(["--arch", arch, "--device", "cpu", "--batch", "1",
                    "--prompt-len", str(3 + _prefix(arch)), "--gen-len", "2"])
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------------------ training --

LOOP = dict(smoke=True, schedule="adaptive", eta=0.12, step_impl="accum_norm",
            steps=4, seq_len=32, base_global_batch=4, max_global_batch=32,
            base_micro_batch=2, max_micro_batch=4, base_accum=2, eval_every=4,
            eval_batches=1, stats_impl="flat", params_impl="flat",
            checkpoint_every=4)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["mamba2-370m", "recurrentgemma-9b",
                                              "whisper-base", "internvl2-1b"])
def test_accum_norm_loop_matches_reference(arch, monkeypatch, tmp_path):
    """`run_training` of both packages from the same parameters: the batch
    trajectory and the step-4 checkpoint's controller plan, counters and
    flags exactly; the losses (MoE aux included), the norm-test statistics,
    the eval loss and the controller's float statistics to rtol 1e-5.
    whisper's and internvl2's batches carry the seeded frames and patch
    embeddings that both packages' `make_batch` draws beside the tokens."""
    job = dict(LOOP, arch=arch)
    hj = jrun(JJob(checkpoint_dir=str(tmp_path / "jax"), **job))
    init_np = jax_tree_np(jbuild(jget(arch)).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, device="cpu":
                        params_from_jax(init_np, self.cfg, device))
    ht = ttrain.run_training(ttrain.TrainJob(
        device="cpu", checkpoint_dir=str(tmp_path / "port"), **job))
    for k in ("global_batch", "samples", "accum_steps", "opt_steps"):
        assert ht[k] == hj[k], k
    for k in ("loss", "T", "var_l1", "grad_sqnorm", "val_loss"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, err_msg=k)
    ctrl = [json.load(open(os.path.join(tmp_path, d, "ckpt_00000004.json")))
            ["controller"] for d in ("jax", "port")]
    # the plan, counters and flags exactly; the float statistics (ema_stat,
    # last_T) come from step metrics that differ in the last bits between
    # the frameworks (ROADMAP §3 parity notes)
    assert sorted(ctrl[0]) == sorted(ctrl[1])
    for k, a in ctrl[1].items():
        if isinstance(a, float):
            np.testing.assert_allclose(a, ctrl[0][k], rtol=1e-5, err_msg=k)
        else:
            assert a == ctrl[0][k], k
