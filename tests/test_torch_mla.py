"""Port MLA (DeepSeek-V2 multi-head latent attention) against the
reference's, float32 on the CPU: `mla_full` on both branches (direct, and
query-chunked at t = 2048) with and without the q low-rank path, its
output and the gradient of every parameter and of x; the prefill latents;
`mla_decode` (absorbed form) at a scalar and at per-row positions, full
cache and ring, with the cache it writes; and the absorbed decode against
the expanded full-sequence form.

Tolerance: rtol 1e-5 with an atol of 1e-5 × the largest magnitude (the two
frameworks, and the absorbed and expanded forms, sum in different
orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np, np32, rng

from repro.models import mla as jmla
from repro.models.config import MLAConfig as JMLA
from repro_torch.models import mla as tmla
from repro_torch.models.config import MLAConfig
from repro_torch.tree import tree_leaves, tree_map

D, H = 32, 4


def close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _layer(q_lora=24, seed=0, heads=H):
    fields = dict(kv_lora_rank=16, q_lora_rank=q_lora, qk_nope_head_dim=8,
                  qk_rope_head_dim=4, v_head_dim=8)
    jm, tm = JMLA(**fields), MLAConfig(**fields)
    p = jax_tree_np(jmla.init_mla(jax.random.PRNGKey(seed), D, heads, jm,
                                  jnp.float32))
    # unit norm scales would hide a scale mixed up between q_norm and kv_norm
    for k in ("q_norm", "kv_norm"):
        if k in p:
            p[k] = {"scale": (1 + 0.1 * rng(seed + 1).standard_normal(
                p[k]["scale"].shape)).astype(np.float32)}
    return jm, tm, p


def _x(seed, b, t):
    return rng(seed).standard_normal((b, t, D)).astype(np.float32)


@pytest.mark.parametrize("t,q_lora,heads", [(20, 24, H), (20, 0, H),
                                            (2048, 24, 2)])
def test_mla_full_and_grads_match_reference(t, q_lora, heads):
    """t = 2048 takes the query-chunked branch in both packages."""
    jm, tm, p = _layer(q_lora, heads=heads)
    x = _x(1, 2 if t < 2048 else 1, t)
    pos = np.broadcast_to(np.arange(t), x.shape[:2]).astype(np.int32)
    w = rng(2).standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        out = jmla.mla_full(p, x, jnp.asarray(pos), jm)
        return jnp.sum(out * w), out
    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    tp = tree_map(lambda a: _t(a).requires_grad_(True), p)
    tx = _t(x).requires_grad_(True)
    out, c_kv, k_rope = tmla.mla_full(tp, tx, _t(pos).long(), tm,
                                      return_latents=True)
    tg = torch.autograd.grad((out * _t(w)).sum(), tree_leaves(tp) + [tx])
    close(out, jout)
    jc, jr = jmla._latents(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(pos), jm)
    close(c_kv, jc)
    close(k_rope, jr)
    want = [np32(a) for a in jax.tree.leaves(jg[0])] + [np32(jg[1])]
    assert len(tg) == len(want)
    for g, w_ in zip(tg, want):
        close(g, w_)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ring", [False, True])
def test_mla_decode_matches_reference(per_row, ring):
    """Steps of one MLA layer against a latent cache of length 8 (a ring
    wraps after 8 positions); per-row positions run the rows 0, 1 and 3
    ahead.  The port writes its cache in place and returns it."""
    b, cache_len, ahead = 3, 8, np.array([0, 1, 3], np.int32)
    jm, tm, p = _layer()
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    jc = jmla.init_mla_cache(b, cache_len, jm, jnp.float32)
    tc = tmla.init_mla_cache(b, cache_len, tm, torch.float32, "cpu")
    tensors = (tc["c_kv"], tc["k_rope"])
    r = rng(3)
    steps = 13 if ring else cache_len - int(ahead.max()) * per_row
    for i in range(steps):
        x = r.standard_normal((b, 1, D)).astype(np.float32)
        if per_row:
            pos = i + ahead
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            jpos, tpos = jnp.int32(i), i
        jout, jc = jmla.mla_decode(jp, jnp.asarray(x), jc, jpos, jm, ring=ring)
        tout, tc = tmla.mla_decode(tp, _t(x), tc, tpos, tm, ring=ring)
        close(tout, jout)
        for k in ("c_kv", "k_rope"):
            close(tc[k], jc[k])
    assert tc["c_kv"] is tensors[0] and tc["k_rope"] is tensors[1]


@pytest.mark.parametrize("q_lora", [24, 0])
def test_absorbed_decode_equals_expanded_prefill(q_lora):
    """Streaming a sequence through the absorbed decode gives, at every
    position, the expanded form's output, and leaves the prefill's
    latents in the cache."""
    _, tm, p = _layer(q_lora, seed=5)
    tp = tree_map(_t, p)
    b, t = 2, 12
    x = _t(_x(6, b, t))
    pos = torch.arange(t).expand(b, t)
    full, c_kv, k_rope = tmla.mla_full(tp, x, pos, tm, return_latents=True)
    cache = tmla.init_mla_cache(b, t, tm, torch.float32, "cpu")
    outs = []
    for i in range(t):
        out, cache = tmla.mla_decode(tp, x[:, i:i + 1], cache, i, tm)
        outs.append(out)
    close(torch.cat(outs, 1), full)
    close(cache["c_kv"], c_kv)
    close(cache["k_rope"], k_rope)
