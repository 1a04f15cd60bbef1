"""GQA attention with RoPE, sliding windows and logit soft-capping over a
full sequence (training / prefill) — counterpart of
`repro/models/attention.py::attend_full`.

Plain PyTorch, like the reference's jnp path: the model never calls the
flash-attention kernel (it is queued for a later slice, off the training
path).  Decode with KV caches arrives with the serving slice.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import normal_init
from repro_torch.models.embeddings import apply_rope

# a large finite negative, not -inf: a fully masked row stays finite
NEG_INF = -2.0e38


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, dtype, device):
    return {
        "wq": normal_init(gen, (d_model, num_heads, head_dim), dtype, device),
        "wk": normal_init(gen, (d_model, num_kv_heads, head_dim), dtype, device),
        "wv": normal_init(gen, (d_model, num_kv_heads, head_dim), dtype, device),
        "wo": normal_init(gen, (num_heads, head_dim, d_model), dtype, device),
    }


def _project_qkv(params, x, positions, rope_theta, qk_norm: bool):
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(x.dtype))
    if qk_norm:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, softcap: float):
    """q: (b,t,h,dk) k/v: (b,s,kv,dk); GQA by kv-head expansion
    (`jnp.repeat` along heads = `repeat_interleave`, not `tile`).
    mask: (t,s), (b,t,s) or None.  Softmax in f32, then cast to v's dtype."""
    h, dk = q.shape[2], q.shape[3]
    kv = k.shape[2]
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float()
    logits = logits / math.sqrt(dk)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def causal_mask(t: int, s: int, offset: int = 0, window: int = 0,
                device=None):
    """(t, s) boolean mask. q position i (global i+offset) sees kv j<=i+offset;
    with window>0 also j > i+offset-window."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


Q_CHUNK = 512
CHUNK_THRESHOLD = 2048  # q-chunked attention for t >= this


def _sdpa_chunked(q, k, v, softcap, causal, window, q_chunk=Q_CHUNK):
    """Memory-bounded attention: a loop over query chunks, each
    recomputed in the backward pass (the reference's checkpointed scan), so
    the logits buffer is O(q_chunk · s) instead of O(t · s)."""
    b, t, h, dk = q.shape
    s = k.shape[1]
    if t % q_chunk:
        raise ValueError(f"sequence {t} is not a multiple of {q_chunk}")

    def body(qi, k, v, ci):
        mask = (causal_mask(q_chunk, s, offset=ci * q_chunk, window=window,
                            device=q.device)
                if (causal or window > 0) else None)
        return _sdpa(qi, k, v, mask, softcap)

    outs = [checkpoint(body, q[:, c * q_chunk:(c + 1) * q_chunk], k, v, c,
                       use_reentrant=False)
            for c in range(t // q_chunk)]
    return torch.cat(outs, dim=1)


def attend_full(params, x, positions, *, rope_theta, softcap=0.0, window=0,
                causal=True, qk_norm=False):
    """Self-attention over a full sequence (training / prefill)."""
    q, k, v = _project_qkv(params, x, positions, rope_theta, qk_norm)
    t = x.shape[1]
    if t >= CHUNK_THRESHOLD and t % Q_CHUNK == 0:
        out = _sdpa_chunked(q, k, v, softcap, causal, window)
    else:
        mask = causal_mask(t, t, 0, window, device=x.device) if causal else None
        out = _sdpa(q, k, v, mask, softcap)
    return torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
