"""Plain reference of a dense pre-norm decoder (Phi-3-mini, arXiv:2404.14219;
the Llama layout it shares): token embedding, per layer RMSNorm → causal
multi-head attention with rotary positions → residual, RMSNorm → SwiGLU
MLP → residual, a final RMSNorm and an untied output head, mean
next-token cross-entropy.

Written from the published equations in plain float32 PyTorch: attention
is naive softmax attention over the whole (t × t) score matrix.  It takes
the parameter tree in the layout the benchmark hands both sides
(`embed/table`, `layers/<i>/attn/wq` of (d, heads, head_dim), ...) and
imports nothing of the program.  Each layer is recomputed in the backward
pass (`torch.utils.checkpoint`) so that the reference fits beside its
optimizer state at the timed sizes.

Also here: the benchmark's own parameter and FLOP counts for this family.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def param_shapes(m: dict) -> dict:
    """The parameter tree (shapes) in the layout both sides are handed."""
    d, h, kv, hd, ff, v = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                           m["head_dim"], m["d_ff"], m["vocab_size"])
    layer = {"pre_norm": {"scale": (d,)}, "mlp_norm": {"scale": (d,)},
             "attn": {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                      "wo": (h, hd, d)},
             "mlp": {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}}
    tree = {"embed": {"table": (v, d)}, "final_norm": {"scale": (d,)},
            "layers": [layer] * m["num_layers"]}
    if not m.get("tie_embeddings", True):
        tree["unembed"] = {"table": (v, d)}
    return tree


def param_count(m: dict) -> int:
    d, h, hd, ff, v = (m["d_model"], m["num_heads"], m["head_dim"], m["d_ff"],
                       m["vocab_size"])
    kv = m["num_kv_heads"]
    layer = 2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    heads = 1 if m.get("tie_embeddings", True) else 2
    return heads * v * d + m["num_layers"] * layer + d


def flops_per_token(m: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token (forward and backward, no
    recomputation): 6 × the parameters outside the embedding lookup (the
    output head counted), plus 12 × layers × attention width × sequence for
    the score and value products (PaLM, arXiv:2204.02311, appendix B)."""
    lookup = m["vocab_size"] * m["d_model"]
    n = param_count(m) - (0 if m.get("tie_embeddings", True) else lookup)
    return 6.0 * n + 12.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * seq_len


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _rope(t: int, hd: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=device) / hd))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv_freq
    ang = torch.cat((ang, ang), dim=-1)                      # (t, hd)
    return ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]


def _layer(x, p_norm, wq, wk, wv, wo, p_norm2, wg, wu, wd, cos, sin, eps):
    b, t, _ = x.shape
    h = _rmsnorm(x, p_norm, eps)
    q = torch.einsum("btd,dhk->bthk", h, wq)
    k = torch.einsum("btd,dhk->bthk", h, wk)
    v = torch.einsum("btd,dhk->bthk", h, wv)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    if k.shape[2] != q.shape[2]:
        k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
        v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    scores = torch.einsum("bthk,bshk->bhts", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    att = torch.einsum("bhts,bshk->bthk", scores.softmax(dim=-1), v)
    x = x + torch.einsum("bthk,hkd->btd", att, wo)
    h = _rmsnorm(x, p_norm2, eps)
    return x + (F.silu(h @ wg) * (h @ wu)) @ wd


def loss(params: dict, tokens, labels, m: dict, eps: float):
    """Mean next-token cross-entropy of (rows, t) `tokens` against
    `labels`."""
    x = F.embedding(tokens.long(), params["embed"]["table"])
    for p in params["layers"]:
        a, f = p["attn"], p["mlp"]
        # layers may lie on several cards, in order (a whole model's
        # reference): the stream follows them
        x = x.to(a["wq"].device)
        cos, sin = _rope(tokens.shape[1], m["head_dim"], m["rope_theta"], x.device)
        x = checkpoint(_layer, x, p["pre_norm"]["scale"], a["wq"], a["wk"],
                       a["wv"], a["wo"], p["mlp_norm"]["scale"], f["w_gate"],
                       f["w_up"], f["w_down"], cos, sin, eps,
                       use_reentrant=False)
    head = (params["embed"] if m.get("tie_embeddings", True)
            else params["unembed"])["table"]
    x = _rmsnorm(x.to(head.device), params["final_norm"]["scale"], eps)
    logits = x @ head.t()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.to(head.device).reshape(-1).long())
