"""Port model against the reference: `loss_fn` and the gradient of every
parameter leaf at identical (converted) parameters, float32.

Tolerance: rtol 1e-5 on the loss, and on each gradient leaf rtol 1e-5 plus
an atol of 1e-5 × the leaf's largest magnitude — the two frameworks sum in
different orders, so entries far below a leaf's scale carry absolute, not
relative, rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro.models import attention as jattn
from repro_torch.configs import get_smoke_config, get_config
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def _batch(cfg, b, t, seed, masked=0):
    """Tokens and shifted labels; a vision config's patch embeddings and an
    audio config's encoder frames, standard normal, beside them."""
    r = rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, t + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1
        labels[0, :masked] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.frontend.kind == "vision_stub":
        batch["patch_embeds"] = r.standard_normal(
            (b, cfg.frontend.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend.kind == "audio_stub":
        batch["frames"] = r.standard_normal(
            (b, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def _compare(arch, b, t, seed, masked=0, **cfg_kw):
    jcfg = jget(arch).replace(**cfg_kw)
    tcfg = get_smoke_config(arch).replace(**cfg_kw)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    batch = _batch(jcfg, b, t, seed + 1, masked)

    (jloss, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))

    tp = params_from_jax(jax_tree_np(jp), tcfg)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tloss, _ = tmodel.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = torch.autograd.grad(tloss, leaves)

    np.testing.assert_allclose(np32(tloss), np32(jloss), rtol=1e-5)
    # the reference's gradient tree, converted like parameters, lines up
    # leaf by leaf with the port's
    want = tree_leaves(params_from_jax(jax_tree_np(jg), tcfg))
    assert len(want) == len(tg)
    for w, g in zip(want, tg):
        w = np32(w)
        np.testing.assert_allclose(np32(g), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ["microllama-300m", "llama3.2-1b",
                                  "tinyllama-1.1b", "openllama-3b"])
def test_loss_and_grads_match_reference(arch):
    _compare(arch, b=2, t=24, seed=3)


def test_masked_labels_match_reference():
    _compare("llama3.2-1b", b=3, t=20, seed=5, masked=7)


def test_chunked_attention_path_matches_reference():
    """t = CHUNK_THRESHOLD takes the q-chunked attention path in both."""
    assert tattn.CHUNK_THRESHOLD == jattn.CHUNK_THRESHOLD
    assert tattn.Q_CHUNK == jattn.Q_CHUNK
    _compare("microllama-300m", b=1, t=tattn.CHUNK_THRESHOLD, seed=7,
             num_layers=1, vocab_size=64)


def test_chunked_xent_and_softcap_match_reference():
    _compare("tinyllama-1.1b", b=2, t=32, seed=9, masked=3, xent_chunk=8,
             final_logit_softcap=30.0, attn_logit_softcap=20.0)


def test_convert_round_trip_and_param_count():
    cfg = jget("tinyllama-1.1b")
    jp = jax_tree_np(jbuild(cfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, get_smoke_config("tinyllama-1.1b"))
    back = params_to_jax(tp, get_smoke_config("tinyllama-1.1b"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    model = build_model(get_smoke_config("tinyllama-1.1b"))
    assert model.num_params(tp) == model.num_params() == cfg.param_count()


def test_full_width_microllama_and_unsupported_configs():
    cfg = get_config("microllama-300m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size) == (12, 1024, 16, 5632, 32000)
    assert cfg.param_count() == 290_743_296
    assert cfg.act_dtype == torch.float32
    with pytest.raises(KeyError, match="supported"):
        get_config("mamba3-1b")
    # tp_boundary is ported (tests/test_torch_tp.py); an unknown remat
    # policy raises, and the model axis takes every layer kind
    # (tests/test_torch_tp_kinds.py)
    build_model(cfg.replace(remat="tp_boundary")).init(device="cpu")
    with pytest.raises(NotImplementedError, match="remat='offload'"):
        build_model(cfg.replace(remat="offload")).init(device="cpu")
    from repro_torch.distributed.params import model_roles, param_pspecs
    from repro_torch.launch.mesh import Mesh
    like = build_model(get_config("mamba2-370m")).init(0, "meta")
    roles = model_roles(like, param_pspecs(like, Mesh((1, 2), ("data", "model"))))
    ssd = roles["layers"][0]["ssd"]
    assert [ssd[k] for k in ("w_in", "conv_w", "w_out", "a_log")] == [
        "sharded", "sharded", "sharded", "replicated"]
    p = build_model(get_smoke_config("llama3.2-1b")).init(seed=1, device="cpu")
    q = build_model(get_smoke_config("llama3.2-1b")).init(seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(q)))
    assert float(p["embed"]["table"].std()) == pytest.approx(0.02, rel=0.05)
