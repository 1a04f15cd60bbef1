"""The encoder-decoder and vision-prefix paths of the port, float32 on the
CPU: whisper's encoder (`transformer.encode`: sinusoidal positions,
non-causal layers) and cross-attention (`attention.cross_attend` over
encoder states and over precomputed k and v) against the reference; its
decode with the cross caches filled (chip_smoke.py's `fill_cross_cache`)
against teacher forcing, as `tests/test_serving.py` holds the reference's;
prefill's cross caches against the reference's `precompute_cross_kv`.
internvl2's forward with its patch prefix (`tests/test_serving.py`'s VLM
case) against the reference, its prefill over the prefix continued by
decode against teacher forcing, and its too-short prompt budget.

Tolerance: rtol 1e-5 with an atol of 1e-5 x the largest magnitude against
the reference; decode against teacher forcing at the reference's own 3e-3.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng

from repro.configs import get_smoke_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models.transformer import encode as jencode
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.serve_step import make_prefill
from repro_torch.launch.serve import run_serving
from repro_torch.models import attention as tattn
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_cross_cache  # noqa: E402


def close(got, want, tol=1e-5):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _models(arch, seed):
    jcfg, tcfg = jget(arch), get_smoke_config(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jm, tm, jp, params_from_jax(jax_tree_np(jp), tcfg)


def _normal(shape, seed):
    return rng(seed).standard_normal(shape).astype(np.float32)


def test_whisper_encode_and_cross_attend_match_reference():
    jcfg, tcfg, _, _, jp, tp = _models("whisper-base", seed=1)
    frames = _normal((2, tcfg.encoder.num_frames, tcfg.d_model), seed=2)
    jenc = jencode(jp, jnp.asarray(frames), jcfg)
    tenc = transformer.encode(tp, torch.from_numpy(frames), tcfg)
    close(tenc, jenc)
    x = _normal((2, 5, tcfg.d_model), seed=3)
    enc = np.array(jenc)
    jlayer = jax.tree.map(lambda a: a[1], jp["blocks"][0])["cross_attn"]
    tlayer = tp["layers"][1]["cross_attn"]
    want = jattn.cross_attend(jlayer, jnp.asarray(x), jnp.asarray(enc))
    close(tattn.cross_attend(tlayer, torch.from_numpy(x), torch.from_numpy(enc)), want)
    kv = tattn.precompute_cross_kv(tlayer, torch.from_numpy(enc))
    jkv = jattn.precompute_cross_kv(jlayer, jnp.asarray(enc))
    for k in ("k", "v"):
        close(kv[k], jkv[k])
    close(tattn.cross_attend(tlayer, torch.from_numpy(x), kv), want)


def test_whisper_decode_matches_teacher_forcing():
    """12 tokens decoded against cross caches filled from the frames equal
    the teacher-forced logits over the same frames (the reference's own
    test and tolerance), and equal the reference's decode."""
    jcfg, tcfg, jm, tm, jp, tp = _models("whisper-base", seed=5)
    b, t = 2, 12
    frames = _normal((b, tcfg.encoder.num_frames, tcfg.d_model), seed=6)
    toks = rng(7).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        full = tm.logits(tp, batch)
    cache = fill_cross_cache(tp, tm.init_cache(b, t, device="cpu"), batch["frames"],
                             tcfg)
    dec = []
    for i in range(t):
        lg, cache = tm.decode_step(tp, cache, batch["tokens"][:, i], i)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    close(dec, full, tol=3e-3)
    with torch.no_grad():
        jfull = jm.logits(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    close(full, jfull)


def test_whisper_prefill_cross_caches_match_reference():
    """Prefill's caches hold every decoder layer's cross k and v over the
    encoded frames, the reference's `precompute_cross_kv` of its encoder
    output; decode continues from them as from a filled cache."""
    jcfg, tcfg, jm, tm, jp, tp = _models("whisper-base", seed=8)
    frames = _normal((2, tcfg.encoder.num_frames, tcfg.d_model), seed=9)
    toks = rng(10).integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    _, caches = make_prefill(tm)(tp, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)})
    enc = jencode(jp, jnp.asarray(frames), jcfg)
    for r, c in enumerate(caches):
        layer = jax.tree.map(lambda a: a[r], jp["blocks"][0])
        want = jattn.precompute_cross_kv(layer["cross_attn"], enc)
        close(c["cross_k"], want["k"])
        close(c["cross_v"], want["v"])


def test_vlm_prefix_forward_matches_reference():
    """(patches + text) through the stack: the text positions' logits, of
    shape (b, t, vocab), equal the reference's and are finite; the loss
    masks the prefix's positions as the reference's does."""
    jcfg, tcfg, jm, tm, jp, tp = _models("internvl2-1b", seed=11)
    b, t, npfx = 2, 8, tcfg.frontend.num_prefix_tokens
    patches = _normal((b, npfx, tcfg.d_model), seed=12)
    toks = rng(13).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "patch_embeds": jnp.asarray(patches)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with torch.no_grad():
        got = tm.logits(tp, tb)
        loss = tm.loss(tp, tb)[0]
    assert got.shape == (b, t, tcfg.vocab_size) and torch.isfinite(got).all()
    close(got, jm.logits(jp, jb))
    close(loss, jm.loss(jp, jb)[0])


def test_vlm_prefill_over_the_prefix_continues_by_decode():
    """Prefill over (patches + 4 text tokens), its caches copied into a
    longer cache, then 4 more text tokens decoded: the decode logits equal
    the teacher-forced logits of those positions (3e-3, the reference's
    decode tolerance), and the prefill's last logits the forward's."""
    _, tcfg, _, tm, _, tp = _models("internvl2-1b", seed=14)
    b, t, k, npfx = 2, 8, 4, tcfg.frontend.num_prefix_tokens
    patches = torch.from_numpy(_normal((b, npfx, tcfg.d_model), seed=15))
    toks = torch.from_numpy(rng(16).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32))
    with torch.no_grad():
        full = tm.logits(tp, {"tokens": toks, "patch_embeds": patches})
    last, caches = make_prefill(tm)(tp, {"tokens": toks[:, :k], "patch_embeds": patches})
    close(last, full[:, k - 1])
    cache = tm.init_cache(b, npfx + t, device="cpu")
    for c, p in zip(cache, caches):
        for key in c:
            c[key][:, :npfx + k] = p[key]
    dec = []
    for i in range(k, t):
        lg, cache = tm.decode_step(tp, cache, toks[:, i], npfx + i)
        dec.append(lg)
    close(torch.stack(dec, dim=1), full[:, k:], tol=3e-3)


def test_serve_driver_vision_prompt_too_short():
    """A prompt budget the vision prefix fills raises, as the reference's
    driver does."""
    npfx = get_smoke_config("internvl2-1b").frontend.num_prefix_tokens
    with pytest.raises(ValueError, match="prefix tokens"):
        run_serving("internvl2-1b", smoke=True, batch=1, prompt_len=npfx,
                    gen_len=2, device="cpu")
    res = run_serving("internvl2-1b", smoke=True, batch=1, prompt_len=npfx + 1,
                      gen_len=2, device="cpu")
    assert res["tokens"].shape == (1, 2)
