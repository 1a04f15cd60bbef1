"""Plain PyTorch versions of every kernel (counterpart of
`repro/kernels/ref.py`): the correctness references the hand-written
kernels are held against, and what a kernel wrapper computes for tensors
that lie on the CPU."""

from __future__ import annotations

import math

import torch


def sqdiff_norm_ref(x, y):
    """Σ (x − y)² in f32 (the norm-test reduction)."""
    d = x.float() - y.float()
    return torch.sum(d * d)


def sqnorm_ref(x):
    return torch.sum(torch.square(x.float()))


def fused_stats_ref(x, y):
    """(Σ(x−y)², Σy²) in f32 — the single-pass norm-test statistics pair."""
    x32 = x.float()
    y32 = y.float()
    d = x32 - y32
    return torch.sum(d * d), torch.sum(y32 * y32)


def adamw_stats_ref(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay,
                    c1, c2, clip_scale=1.0):
    """Flat AdamW with clip scale folded in + pre-clip Σg² byproduct.
    Returns new tensors (p', m', v', Σg²); the inputs are not modified."""
    g32 = g.float()
    gsq = torch.sum(g32 * g32)
    p2, m2, v2 = adamw_ref(p, g32 * clip_scale, m, v, lr=lr, beta1=beta1,
                           beta2=beta2, eps=eps, weight_decay=weight_decay,
                           c1=c1, c2=c2)
    return p2, m2, v2, gsq


def adamw_ref(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1, c2):
    """One AdamW update on a flat tensor (bias-corrected, decoupled decay)."""
    g32 = g.float()
    m = beta1 * m + (1 - beta1) * g32
    v = beta2 * v + (1 - beta2) * torch.square(g32)
    mhat = m / c1
    vhat = v / c2
    p32 = p.float()
    p32 = (1.0 - lr * weight_decay) * p32 - lr * mhat / (torch.sqrt(vhat) + eps)
    return p32.to(p.dtype), m, v


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 / torch.sqrt(var + eps) * scale.float()).to(x.dtype)


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q,k,v: (b, t, h, d) (same head count — GQA expansion happens in the
    wrapper).  Returns (b, t, h, d).  Computes in f32, or in f64 for f64
    inputs (the exact yardstick the f32 kernel and this version are both
    held against at large logits)."""
    t, d = q.shape[1], q.shape[3]
    s = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) / math.sqrt(d)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[None, None], -2.0e38)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(acc)).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The flash-attention kernel's plain version: kv heads expanded in
    `repeat_interleave` order (q head h reads kv head h // (H / KVH), the
    TPU kernel's `kv_map`), then `attention_ref`."""
    group = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, group, dim=2)
    v = torch.repeat_interleave(v, group, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
