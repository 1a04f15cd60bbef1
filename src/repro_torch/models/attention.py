"""GQA attention with RoPE, sliding windows, logit soft-capping and KV
caches — counterpart of `repro/models/attention.py`:

* `attend_full`   — training / prefill over a whole sequence;
* `cross_attend`, `precompute_cross_kv` — encoder-decoder (Whisper)
  cross-attention over encoder states or their precomputed k and v;
* `attend_decode` — one token a row against a KV cache, at a scalar
  position or at per-row positions, the cache full-length or a ring;
* `init_cache`.

Training steps run the plain PyTorch path, like the reference's jnp
path.  Every forward on the card with grad mode off — prefill, and the
training loop's eval loss under `torch.no_grad` — runs the flash-attention
kernel (`kernels.ops.flash_attention`, any head dim up to 256), the
reference's TPU drop-in for the same math; so does cross-attention there,
non-causal over the encoder's frames (decode steps included).  Off the
card such a forward calls the same entry point, which runs the plain code
passed to it.  Decode's self-attention runs the plain `_sdpa_grouped`, as
the reference does.

Tensor parallelism (`distributed/sharding.py`): when `wq` holds fewer
heads than the config's `num_heads`, it is this rank's shard over the
model axis (heads [m·h, (m+1)·h)); `wk` / `wv` are its kv heads' shard
too, or whole when the kv heads do not divide the axis, and then each
local q head reads its kv head by its global index (the local heads then
run as MHA).  The input enters
through `tp_enter`, `wo`'s product is a partial sum made whole by
`maybe_shard` at the reference's exit.  Prefill returns its k and v in
the cache's layout (`distributed/params.py::cache_pspecs`): the rank's kv
heads, or all of them when they do not divide the axis.  Decode reads the
cache in that layout, one of three cases:

(a) the kv heads divide the axis: the rank holds its kv heads;
(b) they do not, and the cache is shorter than `params.SEQ_SHARD_LEN`: the
    rank holds the whole cache, and each local q head reads its kv head
    by global index;
(c) they do not, and the cache is that long: the rank holds its slice of
    the positions and writes the new k and v only when the position falls
    in it; every head's partial softmax over the slice (the q heads
    all-gathered) is combined over the model group (`sharded_softmax`),
    and the rank keeps its own heads' output.

Under sequence parallelism (training) x is this rank's slice of the
stream: it enters through `stream_enter` (the slices all-gathered, so q,
k and v see every position) and leaves through the exit's reduce-scatter;
cross-attention's source is the encoder's whole output.  Whole leaves run
on the gathered rows and the rank keeps its slice of the result.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, model_size, stream_enter, stream_gather,
    stream_scatter, tp_enter, tp_gather, tp_max, tp_reduce)
from repro_torch.kernels import ops
from repro_torch.models.common import normal_init
from repro_torch.models.embeddings import apply_rope
from repro_torch.tracing import span

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


def _sdpa_grouped(q, k, v, mask, softcap: float):
    """Grouped-query attention for DECODE: q is reshaped to (b,t,kv,g,d) so
    the KV cache is read once, never expanded.  mask: (t,s), (b,t,s) or
    (b,1,s).  Softmax in f32, then cast to v's dtype."""
    b, t, h, dk = q.shape
    kv = k.shape[2]
    q = q.reshape(b, t, kv, h // kv, dk)
    logits = torch.einsum("btkgd,bskd->bkgts", q, k).float()
    logits = logits / math.sqrt(dk)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None, None]
        elif mask.dim() == 3:
            mask = mask[:, None, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h, dk)


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
        with span("model.attention"):
            mask = (causal_mask(q_chunk, s, offset=ci * q_chunk, window=window,
                                device=q.device)
                    if (causal or window > 0) else None)
            return _sdpa(qi, k, v, mask, softcap)

    outs = [checkpoint(body, q[:, c * q_chunk:(c + 1) * q_chunk], k, v, c,
                       use_reentrant=False)
            for c in range(t // q_chunk)]
    return torch.cat(outs, dim=1)


def _tp_heads(params, num_heads):
    """(model index, local heads) when `params` hold this rank's shard of
    the heads; else None."""
    tp = model_axis()
    if tp is None or num_heads is None or params["wq"].shape[1] == num_heads:
        return None
    return tp[1], params["wq"].shape[1]


def _local_kv(k, v, shard, num_heads, num_kv_heads):
    """The kv heads of this rank's q heads: k, v themselves when they are
    its shard; from whole k, v (kv heads that do not divide the model axis)
    one kv head per local q head, picked by the q head's global index."""
    if k.shape[2] < num_kv_heads:
        return k, v
    m, h = shard
    idx = torch.div(m * h + torch.arange(h, device=k.device),
                    num_heads // num_kv_heads, rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def _attend_plain(q, k, v, causal, window, softcap):
    """Full-sequence attention in plain PyTorch (long sequences by query
    chunks)."""
    t = q.shape[1]
    if t >= CHUNK_THRESHOLD and t % Q_CHUNK == 0:
        return _sdpa_chunked(q, k, v, softcap, causal, window)
    mask = causal_mask(t, t, 0, window, device=q.device) if causal else None
    return _sdpa(q, k, v, mask, softcap)


def attend_full(params, x, positions, *, rope_theta, softcap=0.0, window=0,
                causal=True, qk_norm=False, return_kv=False, num_heads=None,
                num_kv_heads=None):
    """Self-attention over a full sequence (training / prefill).  On the
    card with grad mode off it runs the flash-attention kernel.  With
    `return_kv` it returns (out, k, v), k and v after RoPE — the prefill
    cache.  `num_heads` / `num_kv_heads` are the config's: leaves with
    fewer heads are this rank's shard (module docstring)."""
    shard = _tp_heads(params, num_heads)
    x = stream_gather(x) if shard is None else stream_enter(x)
    q, k, v = _project_qkv(params, x, positions, rope_theta, qk_norm)
    kv = (k, v)                       # the cache: kv heads as the rank holds them
    if shard is not None:
        k, v = _local_kv(k, v, shard, num_heads, num_kv_heads)
    plain = lambda: _attend_plain(q, k, v, causal, window, softcap)
    if torch.is_grad_enabled():
        out = plain()
    else:
        # the kernel's entry point on every device: the card launches
        # flash, another device runs `plain`
        out = ops.flash_attention(q, k, v, causal=causal,
                                  window=window if causal else 0,
                                  softcap=softcap, plain=plain)
    out = torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
    out = (stream_scatter(out) if shard is None
           else maybe_shard(out, "batch", "seq", "embed"))
    return (out, *kv) if return_kv else out


def cross_attend(params, x, kv_source, *, softcap=0.0, num_heads=None,
                 num_kv_heads=None):
    """Encoder-decoder cross-attention, non-causal; kv_source is either
    encoder hidden states (b, s, d) or a precomputed {"k", "v"}.  On the
    card with grad mode off it runs the flash-attention kernel.  Sharded
    leaves as in `attend_full` (the encoder states, whole, enter through
    `tp_enter`)."""
    shard = _tp_heads(params, num_heads)
    x = stream_gather(x) if shard is None else stream_enter(x)
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    if isinstance(kv_source, dict):
        k, v = kv_source["k"].to(x.dtype), kv_source["v"].to(x.dtype)
    else:
        src = kv_source.to(x.dtype)
        k, v = precompute_cross_kv(params, src if shard is None
                                   else tp_enter(src)).values()
    if shard is not None:
        k, v = _local_kv(k, v, shard, num_heads, num_kv_heads)
    if torch.is_grad_enabled():
        out = _sdpa(q, k, v, None, softcap)
    else:
        out = ops.flash_attention(q, k, v, causal=False, softcap=softcap,
                                  plain=lambda: _sdpa(q, k, v, None, softcap))
    out = torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
    return (stream_scatter(out) if shard is None
            else maybe_shard(out, "batch", "seq", "embed"))


def precompute_cross_kv(params, enc_out):
    return {"k": torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(enc_out.dtype)),
            "v": torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(enc_out.dtype))}


# ------------------------------------------------------------- KV cache ----

def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype, device):
    """Full-length cache, or a ring buffer (pass cache_len=window)."""
    shape = (batch, cache_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def sharded_softmax(logits):
    """Softmax over a last axis whose entries are cut over the model group
    (case (c)): this rank's part of the probabilities, from the group's
    max (`tp_max`) and sum (`tp_reduce`).  The caller all-reduces its
    P·V partial."""
    top = tp_max(logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - top)
    return p / tp_reduce(p.sum(dim=-1, keepdim=True))


def write_positions(c, new, slot, per_row: bool, start=None):
    """Write `new` (b, 1, ...) into cache tensor `c` (b, length, ...) IN
    PLACE at position `slot` (an int, or a (b,) tensor per row).  `start`
    None: `c` holds every position.  Else it holds positions [start,
    start + length) (case (c)): a scalar position outside them writes
    nothing, and a row whose position falls outside them writes back the
    value it read, so no host read decides anything."""
    if start is None:
        if per_row:
            rows = torch.arange(c.shape[0], device=c.device)
            c.index_put_((rows, slot), new[:, 0].to(c.dtype))
        else:
            c[:, slot:slot + 1].copy_(new)
        return
    length = c.shape[1]
    if per_row:
        rows = torch.arange(c.shape[0], device=c.device)
        local = slot - start
        idx = local.clamp(0, length - 1)
        keep = c[rows, idx]
        inside = ((local >= 0) & (local < length)).view(-1, *([1] * (keep.dim() - 1)))
        c.index_put_((rows, idx), torch.where(inside, new[:, 0].to(c.dtype), keep))
    elif start <= slot < start + length:
        c[:, slot - start:slot - start + 1].copy_(new)


def attend_decode(params, x, cache, pos, *, rope_theta, softcap=0.0,
                  ring: bool = False, qk_norm=False, num_heads=None,
                  num_kv_heads=None, seq_sharded: bool = False):
    """Single-token decode.  x: (b,1,d); pos: a scalar global position (an
    int or a 0-d tensor), or a (b,) integer tensor of PER-ROW positions
    (continuous batching: each cache row advances on its own timeline,
    writes its own slot and masks its own prefix).  `ring=True` treats the
    cache as a circular sliding-window buffer of length cache_len.

    The new k and v are written into `cache`'s tensors IN PLACE (a slice
    copy for a scalar position, `index_put_` for per-row positions), where
    the reference returns an updated copy; a cache whose tensors are views
    of a larger buffer updates that buffer.  `num_heads` / `num_kv_heads`
    are the config's: leaves with fewer heads are this rank's shard, and
    the cache is in one of the module docstring's three layouts,
    `seq_sharded` saying it is case (c)'s slice of the positions.
    Returns (out, cache)."""
    shard = _tp_heads(params, num_heads)
    if shard is not None:
        x = tp_enter(x)
    b = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    length = kc.shape[1]
    start = None
    if seq_sharded and shard is not None:
        start = shard[0] * length
        cache_len = length * model_size()
    else:
        cache_len = length
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    if per_row:
        pos = pos.to(device=x.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, positions, rope_theta, qk_norm)
    slot = pos % cache_len if ring else pos
    if not per_row:
        # the reference's dynamic_update_slice clamps the start in range
        slot = min(max(slot, 0), cache_len - 1)
    write_positions(kc, k_new, slot, per_row, start)
    write_positions(vc, v_new, slot, per_row, start)
    kpos = torch.arange(length, device=x.device) + (start or 0)
    # a scalar position stays a Python int: no host-to-device copy a step
    ppos = pos[:, None] if per_row else pos
    if ring:
        # valid slots: all once pos>=cache_len-1, else slots <= pos
        valid = kpos <= (torch.clamp(ppos, min=cache_len - 1) if per_row
                         else max(ppos, cache_len - 1))
        valid &= (kpos <= ppos) | (ppos >= cache_len)
    else:
        valid = kpos <= ppos
    mask = valid[:, None, :] if per_row else valid[None, None, :]
    k, v = kc.to(x.dtype), vc.to(x.dtype)
    if start is not None:
        out = _decode_seq_sharded(q, k, v, mask, softcap, shard)
    else:
        if shard is not None:
            k, v = _local_kv(k, v, shard, num_heads, num_kv_heads)
        out = _sdpa_grouped(q, k, v, mask, softcap)
    out = torch.einsum("bthk,hkd->btd", out, params["wo"].to(x.dtype))
    if shard is not None:
        out = maybe_shard(out, "batch", "seq", "embed")
    return out, cache


def _decode_seq_sharded(q, k, v, mask, softcap, shard):
    """Case (c): every q head (gathered over the model group) against this
    rank's positions of the whole kv heads, the partial softmaxes combined
    over the group; returns this rank's heads' output (b, 1, h, d)."""
    m, h = shard
    q = tp_gather(q, 2)
    b, t, heads, dk = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, heads // kv, dk)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() / math.sqrt(dk)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    probs = sharded_softmax(logits.masked_fill(~mask[:, None, None], NEG_INF))
    probs = probs.to(v.dtype)
    out = tp_reduce(torch.einsum("bkgts,bskd->btkgd", probs, v))
    return out.reshape(b, t, heads, dk)[:, :, m * h:(m + 1) * h]
