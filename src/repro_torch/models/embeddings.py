"""Token embeddings, tied/untied unembedding, RoPE and sinusoidal positions
(counterpart of `repro/models/embeddings.py`).

Tensor parallelism: a `table` with fewer rows than the config's vocab is
this rank's vocab shard (rows [m·n, (m+1)·n)).  The lookup is then
vocab-parallel — each rank looks up the tokens in its rows, zeros for the
rest, and the sum over the model group is every token's row — and the
unembedding gives this rank's columns of the logits (`vocab_shard`).
Under sequence parallelism (`sliced`) the lookup's sum is reduce-scattered
instead: the residual stream is born as this rank's slice of the
sequence."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    model_axis, stream_exit, stream_scatter, tp_enter, tp_reduce)
from repro_torch.kernels import ops
from repro_torch.models.common import normal_init


def init_embedding(gen, vocab: int, d: int, dtype, device):
    return {"table": normal_init(gen, (vocab, d), dtype, device)}


def vocab_shard(table, vocab: int | None):
    """(first row, rows) of this rank's vocab shard when `table` is one;
    else None."""
    tp = model_axis()
    if tp is None or vocab is None or table.shape[0] == vocab:
        return None
    return tp[1] * table.shape[0], table.shape[0]


def embed_tokens(params, tokens, scale: bool, d_model: int,
                 vocab: int | None = None, sliced: bool = False):
    """The tokens' rows (b, t, d); `sliced` (under sequence parallelism):
    this rank's slice of the sequence."""
    shard = vocab_shard(params["table"], vocab)
    if shard is not None:
        v0, n = shard
        local = tokens.long() - v0
        inside = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), params["table"])
        x = x * inside[..., None].to(x.dtype)
        x = stream_exit(x) if sliced else tp_reduce(x)
    else:
        x = _lookup(params["table"], tokens)
        if sliced:
            x = stream_scatter(x)
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype)
    return x


def _lookup(table, tokens):
    # F.embedding, not indexing: the backward of `table[tokens]` accumulates
    # with parallel float atomics on the CPU once a batch holds 32768
    # elements or more, so repeated tokens summed in a different order from
    # run to run; F.embedding's backward adds each table row's gradients in
    # token order on the CPU and sorts on the card — the same bits every
    # run, which bit-exact resume needs
    return F.embedding(tokens.long(), table)


def unembed(params, x, tied_table=None, vocab: int | None = None,
            entered: bool = False):
    """Project hidden states to vocab logits (tied or untied); a vocab
    shard gives this rank's columns, x entering through `tp_enter` unless
    it has `entered` already (the sequence-parallel gather).  The product
    goes through `kernels.ops.dense`, the table read K-major in place."""
    table = tied_table if tied_table is not None else params["table"]
    if vocab_shard(table, vocab) is not None and not entered:
        x = tp_enter(x)
    return ops.dense("...d,vd->...v", x, table.to(x.dtype))


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


# ---------------------------------------------------------- sinusoidal ----

def _inv_timescales(d: int, device):
    log_timescale = math.log(10000.0) / (d // 2 - 1)
    return torch.exp(-log_timescale * torch.arange(d // 2, dtype=torch.float32,
                                                   device=device))


def sinusoidal_at(pos, d: int, dtype, device=None):
    """Sinusoidal embedding row(s) at position `pos`: an int or a 0-d tensor
    -> (d,); a (b,) tensor of per-row positions -> (b, d)."""
    if torch.is_tensor(pos):
        device = pos.device
        p = pos.float()
        scaled = (p[:, None] if p.dim() == 1 else p) * _inv_timescales(d, device)
    else:
        scaled = float(pos) * _inv_timescales(d, device)
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).to(dtype)


def sinusoidal_positions(num_pos: int, d: int, dtype, device=None):
    """Whisper-style fixed sinusoidal embeddings, shape (num_pos, d)."""
    scaled = (torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
              * _inv_timescales(d, device)[None, :])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).to(dtype)
