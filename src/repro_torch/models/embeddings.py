"""Token embeddings, tied/untied unembedding and RoPE (counterpart of
`repro/models/embeddings.py`)."""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import normal_init


def init_embedding(gen, vocab: int, d: int, dtype, device):
    return {"table": normal_init(gen, (vocab, d), dtype, device)}


def embed_tokens(params, tokens, scale: bool, d_model: int):
    x = params["table"][tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype)
    return x


def unembed(params, x, tied_table=None):
    """Project hidden states to vocab logits (tied or untied)."""
    table = tied_table if tied_table is not None else params["table"]
    return torch.einsum("...d,vd->...v", x, table.to(x.dtype))


# ---------------------------------------------------------------- RoPE ----

def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.

    Rotates the two split HALVES of head_dim (not interleaved pairs), with
    f32 angles, exactly as the reference does."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
