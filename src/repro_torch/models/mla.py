"""DeepSeek-V2 Multi-head Latent Attention (MLA) — counterpart of
`repro/models/mla.py`.

Training and prefill use the expanded form; decode uses the *absorbed*
form that attends directly in the compressed latent space: the cache holds
only `c_kv` (rank 512 in deepseek-v2) and the shared RoPE key, not per-head
K and V.  The attention is plain einsum and softmax, as in the reference
(MLA's q·k dim differs from its v dim, and the reference never sends it
through its flash kernel); `q_norm` and `kv_norm` are RMSNorms, so on the
card with grad mode off they run the `rmsnorm` kernel.

Tensor parallelism (`distributed/sharding.py`): when `w_uk` holds fewer
heads than the config's, `w_uq`, `w_uk`, `w_uv` and `w_o` are this rank's
heads [m·h, (m+1)·h).  The latent projections before the head split
(`w_dq`, `q_norm`, `w_dkv`, `kv_norm`, `w_krope`) run whole on every rank,
and the column-parallel entry (`tp_enter`) sits after them, on `cq`, `c_kv`
and the RoPE key, so their gradients come out whole ("replicated").  A
whole `w_q` (no query LoRA) gives this rank's heads from x entering
through `tp_enter`, so its gradient is a partial sum ("partial").  `w_o`'s
product is the exit (`maybe_shard`).  The chunked path runs on the local
heads.  The absorbed decode runs the same split: the rank's heads of the
absorbed query and of `w_uv` / `w_o`, against the latent cache that every
rank holds whole (the latents come from replicated leaves), or, from
`params.SEQ_SHARD_LEN` positions, its slice of the positions: then every
head's partial softmax over the slice (the absorbed queries all-gathered)
is combined over the group (`attention.sharded_softmax`), as attention's
case (c).

Under sequence parallelism (training) the latent projections and their
norms need whole rows: x is all-gathered whole at the entry
(`stream_gather`, whose backward takes this rank's slice of a gradient
that `tp_enter` has already made the same on every rank), and the exit
reduce-scatters into this rank's slice of the stream.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, model_size, stream_gather, stream_scatter,
    tp_enter, tp_gather, tp_reduce)
from repro_torch.models.attention import (
    NEG_INF, causal_mask, sharded_softmax, write_positions)
from repro_torch.models.common import normal_init
from repro_torch.models.config import MLAConfig
from repro_torch.models.embeddings import apply_rope
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.tracing import span

Q_CHUNK = 512
CHUNK_THRESHOLD = 2048   # query-chunked attention for t >= this


def init_mla(gen, d_model: int, num_heads: int, m: MLAConfig, dtype, device):
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    init = lambda shape: normal_init(gen, shape, dtype, device)
    p = {}
    if m.q_lora_rank:
        p["w_dq"] = init((d_model, m.q_lora_rank))
        p["q_norm"] = init_norm(m.q_lora_rank, "rmsnorm", dtype, device)
        p["w_uq"] = init((m.q_lora_rank, num_heads, qk_dim))
    else:
        p["w_q"] = init((d_model, num_heads, qk_dim))
    p["w_dkv"] = init((d_model, m.kv_lora_rank))
    p["kv_norm"] = init_norm(m.kv_lora_rank, "rmsnorm", dtype, device)
    p["w_krope"] = init((d_model, m.qk_rope_head_dim))
    p["w_uk"] = init((m.kv_lora_rank, num_heads, m.qk_nope_head_dim))
    p["w_uv"] = init((m.kv_lora_rank, num_heads, m.v_head_dim))
    p["w_o"] = init((num_heads, m.v_head_dim, d_model))
    return p


def _queries(params, x, positions, m: MLAConfig, shard=None):
    """(q_nope, q_rope); `shard` (model index, local heads) on a model
    axis (module docstring)."""
    if "w_dq" in params:
        cq = torch.einsum("btd,dr->btr", x, params["w_dq"].to(x.dtype))
        cq = apply_norm(params["q_norm"], cq, "rmsnorm")
        if shard is not None:
            cq = tp_enter(cq)
        q = torch.einsum("btr,rhk->bthk", cq, params["w_uq"].to(x.dtype))
    else:
        w_q = params["w_q"]
        if shard is not None:
            x = tp_enter(x)
            w_q = w_q[:, shard[0] * shard[1]:(shard[0] + 1) * shard[1]]
        q = torch.einsum("btd,dhk->bthk", x, w_q.to(x.dtype))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, 10000.0)
    return q_nope, q_rope


def _latents(params, x, positions, m: MLAConfig):
    c_kv = torch.einsum("btd,dr->btr", x, params["w_dkv"].to(x.dtype))
    c_kv = apply_norm(params["kv_norm"], c_kv, "rmsnorm")
    k_rope = torch.einsum("btd,dr->btr", x, params["w_krope"].to(x.dtype))
    # the shared RoPE key: one head
    k_rope = apply_rope(k_rope[:, :, None, :], positions, 10000.0)[:, :, 0, :]
    return c_kv, k_rope


def _scale(m: MLAConfig) -> float:
    """1/sqrt(q·k dim), rounded in f32 as the reference computes it."""
    dim = np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim)
    return float(np.float32(1.0) / np.sqrt(dim))


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, m: MLAConfig,
                causal: bool, offset: int = 0):
    """One (possibly chunked) MLA attention: q over the full kv."""
    t, s = q_nope.shape[1], k_nope.shape[1]
    logits = torch.einsum("bthn,bshn->bhts", q_nope, k_nope)
    logits = logits + torch.einsum("bthr,bsr->bhts", q_rope, k_rope)
    logits = logits.float() * _scale(m)
    if causal:
        mask = causal_mask(t, s, offset=offset, device=logits.device)
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshv->bthv", probs, v)


def mla_full(params, x, positions, m: MLAConfig, causal: bool = True,
             q_chunk: int = Q_CHUNK, return_latents: bool = False,
             num_heads: int | None = None):
    """Expanded-form MLA over a full sequence (training / prefill).  From
    t >= 2048 (a multiple of `q_chunk`) the queries run in chunks, each
    recomputed in the backward pass (the reference's checkpointed scan).
    With `return_latents` it returns (out, c_kv, k_rope) — the prefill
    cache.  `num_heads` is the config's: leaves with fewer heads are this
    rank's shard (module docstring).  The whole call is the span
    `model.mla`; each query chunk's attention, `model.attention`."""
    with span("model.mla"):
        x = stream_gather(x)
        b, t, _ = x.shape
        tp = model_axis()
        h = params["w_uk"].shape[1]
        shard = (tp[1], h) if tp is not None and num_heads not in (None, h) else None
        q_nope, q_rope = _queries(params, x, positions, m, shard)
        c_kv, k_rope = cache = _latents(params, x, positions, m)
        if shard is not None:
            c_kv, k_rope = tp_enter(c_kv), tp_enter(k_rope)
        k_nope = torch.einsum("btr,rhn->bthn", c_kv, params["w_uk"].to(x.dtype))
        v = torch.einsum("btr,rhv->bthv", c_kv, params["w_uv"].to(x.dtype))
        if t >= CHUNK_THRESHOLD and t % q_chunk == 0:
            def body(qn, qr, k_nope, k_rope, v, c):
                with span("model.attention"):
                    return _mla_attend(qn, qr, k_nope, k_rope, v, m, causal,
                                       offset=c * q_chunk)

            out = torch.cat([
                checkpoint(body, q_nope[:, c * q_chunk:(c + 1) * q_chunk],
                           q_rope[:, c * q_chunk:(c + 1) * q_chunk],
                           k_nope, k_rope, v, c, use_reentrant=False)
                for c in range(t // q_chunk)], dim=1)
        else:
            out = _mla_attend(q_nope, q_rope, k_nope, k_rope, v, m, causal)
        out = torch.einsum("bthv,hvd->btd", out, params["w_o"].to(x.dtype))
        out = (stream_scatter(out) if shard is None
               else maybe_shard(out, "batch", "seq", "embed"))
        return (out, *cache) if return_latents else out


def init_mla_cache(batch: int, cache_len: int, m: MLAConfig, dtype, device):
    return {"c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(params, x, cache, pos, m: MLAConfig, ring: bool = False,
               num_heads: int | None = None, seq_sharded: bool = False):
    """Absorbed-form single-token decode against the latent cache.  `pos`
    is a scalar position (an int or a 0-d tensor) or a (b,) integer tensor
    of per-row positions (continuous batching: each row writes and masks
    its own timeline).  The new latents are written into `cache`'s tensors
    IN PLACE, as in `attention.attend_decode`.  `num_heads` is the
    config's: leaves with fewer heads are this rank's shard, and
    `seq_sharded` says the cache is its slice of the positions (module
    docstring).  Returns (out, cache)."""
    b = x.shape[0]
    tp = model_axis()
    h = params["w_uk"].shape[1]
    shard = (tp[1], h) if tp is not None and num_heads not in (None, h) else None
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    length = c_cache.shape[1]
    start = shard[0] * length if seq_sharded and shard is not None else None
    cache_len = length * model_size() if start is not None else length
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    if per_row:
        pos = pos.to(device=x.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _queries(params, x, positions, m, shard)     # (b,1,h,*)
    c_new, kr_new = _latents(params, x, positions, m)             # (b,1,r)
    slot = pos % cache_len if ring else pos
    if not per_row:
        # the reference's dynamic_update_slice clamps the start in range
        slot = min(max(slot, 0), cache_len - 1)
    write_positions(c_cache, c_new, slot, per_row, start)
    write_positions(r_cache, kr_new, slot, per_row, start)
    # absorb W_uk into the query: attend in latent space
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, params["w_uk"].to(x.dtype))
    if start is not None:
        q_lat, q_rope = tp_gather(q_lat, 2), tp_gather(q_rope, 2)
    c_kv, k_rope = c_cache.to(x.dtype), r_cache.to(x.dtype)
    logits = torch.einsum("bthr,bsr->bhts", q_lat, c_kv)
    logits = logits + torch.einsum("bthr,bsr->bhts", q_rope, k_rope)
    logits = logits.float() * _scale(m)
    kpos = torch.arange(length, device=x.device) + (start or 0)
    ppos = pos[:, None] if per_row else pos
    valid = kpos <= ppos
    if ring:
        valid = valid | (ppos >= cache_len)
    mask = valid[:, None, None, :] if per_row else valid[None, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    if start is None:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out_lat = torch.einsum("bhts,bsr->bthr", probs, c_kv)
    else:
        probs = sharded_softmax(logits).to(x.dtype)
        out_lat = tp_reduce(torch.einsum("bhts,bsr->bthr", probs, c_kv))
        out_lat = out_lat[:, :, shard[0] * h:(shard[0] + 1) * h]
    out = torch.einsum("bthr,rhv->bthv", out_lat, params["w_uv"].to(x.dtype))
    out = torch.einsum("bthv,hvd->btd", out, params["w_o"].to(x.dtype))
    if shard is not None:
        out = maybe_shard(out, "batch", "seq", "embed")
    return out, cache
