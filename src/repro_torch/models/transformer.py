"""Decoder-only / encoder-decoder transformer stack: init, the Whisper
encoder, forward with stub modality frontends (vision patch prefix, audio
frames), masked cross-entropy with the MoE aux loss, prefill and decode
(counterpart of `repro/models/transformer.py`).

The reference scans stacked per-layer parameters (`blocks`, a leading
repeat axis) after unscanned `prefix_blocks`; the port keeps one parameter
dict per layer in `layers`, in execution order, and runs a Python loop.
The encoder subtree (`encoder`: `blocks`, `final_norm`) is the
reference's as it is.  Likewise the decode cache is a list with one cache
per layer ({"k", "v"}; MLA's {"c_kv", "k_rope"}; RG-LRU's {"h", "conv"};
SSD's {"ssm", "conv"}), where the reference stacks `scanned` caches; an
encoder-decoder layer's cache also holds its cross-attention k and v over
the encoder's frames ("cross_k", "cross_v"), the reference's
`cross_prefix` / `cross_scanned`.  `models/convert.py` maps between the
two layouts.

Cross-entropy can run in sequence chunks (`cfg.xent_chunk`), each chunk's
logits recomputed in the backward pass, so the (batch, seq, vocab) logits
tensor is never materialized whole.

Under a model axis (`distributed/sharding.py`) the leaves are this rank's
shards: attention and the MLP run on its heads and ffn columns, and with
the table on the axis the lookup and the cross-entropy are vocab-parallel
— the max, Σexp and the target logit are reduced over the model group, so
no rank holds the whole logits.  `remat="tp_boundary"` recomputes each
layer in the backward pass but keeps its row-parallel outputs, so the
forward's all-reduces never run twice.  Serving on a model axis: prefill
and decode return whole logits on every rank (the rank's vocab columns
all-gathered, `tp_gather`), so the greedy pick is the reference's, and
prefill's caches come out in `cache_pspecs`'s layout (attention's kv heads
as the rank holds them, a long cache's positions and MLA's long latents
the rank's slice of them).

Sequence parallelism (training under `with_sequence_parallel` rules): the
stream is built whole — the vision prefix concatenated, the position
terms added — and then cut to this rank's slice of the sequence, or born
as that slice by the vocab-parallel lookup's reduce-scatter; Whisper's
encoder input likewise, its output gathered whole for every layer's
cross-attention.  The blocks and the final norm run on the slice, and the
cross-entropy gathers it back into whole rows.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.params import seq_sharded
from repro_torch.distributed.sharding import (
    checkpoint_tp_boundary, model_axis, model_size, seq_parallel, stream_enter,
    stream_gather, stream_length, stream_scatter, tp_gather, tp_max, tp_reduce)
from repro_torch.models import blocks as blk
from repro_torch.models.attention import (
    cross_attend, init_attention, precompute_cross_kv)
from repro_torch.models.common import resolve_device
from repro_torch.models.config import ATTN, MLA_ATTN, ModelConfig
from repro_torch.models.embeddings import (
    embed_tokens, init_embedding, sinusoidal_at, sinusoidal_positions, unembed,
    vocab_shard)
from repro_torch.models.norms import init_norm, apply_norm
from repro_torch.tracing import span


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """Kind of every layer in execution order (prefix, then the repeats of
    the block pattern)."""
    return cfg.prefix_pattern + cfg.block_pattern * cfg.num_repeats


def layer_plan(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(kind, moe_layer) of every layer in execution order: prefix layers
    stay dense, pattern layers take MoE when `cfg.moe` is set."""
    return ([(kind, False) for kind in cfg.prefix_pattern]
            + [(kind, cfg.moe is not None)
               for kind in cfg.block_pattern] * cfg.num_repeats)


# ------------------------------------------------------------------ init ----

def _init_one_block(gen, cfg, kind, moe_layer, device):
    p = blk.init_block(gen, cfg, kind, moe_layer, device)
    if cfg.encoder is not None:  # decoder cross-attention sub-layer
        p["cross_norm"] = init_norm(cfg.d_model, cfg.norm_kind, cfg.p_dtype, device)
        p["cross_attn"] = init_attention(gen, cfg.d_model, cfg.num_heads,
                                         cfg.num_kv_heads, cfg.head_dim,
                                         cfg.p_dtype, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters: normal(0, 0.02) weights, unit norm scales, drawn
    from a `torch.Generator` seeded with `seed` on `device` (default: the
    CUDA card; raises when there is none).  On the "meta" device: shapes
    and dtypes only (what `distributed/params.py` reads)."""
    blk.check_supported(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.p_dtype, device)}
    params["layers"] = [_init_one_block(gen, cfg, kind, moe_layer, device)
                        for kind, moe_layer in layer_plan(cfg)]
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_kind, cfg.p_dtype,
                                     device)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.p_dtype, device)
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": [blk.init_block(gen, cfg, ATTN, False, device)
                       for _ in range(cfg.encoder.num_layers)],
            "final_norm": init_norm(cfg.d_model, cfg.norm_kind, cfg.p_dtype, device),
        }
    return params


# --------------------------------------------------------------- encoder ----

def encode(params, frames, cfg: ModelConfig):
    """Whisper-style encoder over stub frame embeddings (b, nf, d):
    sinusoidal positions, non-causal attention layers, a final norm.  Under
    sequence parallelism the layers and the norm run on this rank's slice
    of the frames, and the output is gathered whole."""
    b, nf = frames.shape[:2]
    x = frames + sinusoidal_positions(nf, cfg.d_model, frames.dtype,
                                      frames.device)[None]
    x = stream_scatter(x)
    positions = torch.arange(nf, device=frames.device).expand(b, nf)
    for p in params["encoder"]["blocks"]:
        x = blk.block_full(p, x, positions, cfg, ATTN, False, causal=False)[0]
    with stream_length(nf):
        return stream_gather(apply_norm(params["encoder"]["final_norm"], x,
                                        cfg.norm_kind))


# ----------------------------------------------------------------- stack ----

def _apply_cross(p, x, enc, cfg):
    if enc is not None and "cross_attn" in p:
        h = apply_norm(p["cross_norm"], x, cfg.norm_kind)
        x = x + cross_attend(p["cross_attn"], h, enc, num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads)
    return x


def _block(p, x, positions, enc, cfg, kind, moe_layer):
    with span("model.block"), stream_length(positions.shape[-1]):
        x, a, _ = blk.block_full(p, x, positions, cfg, kind, moe_layer)
        return _apply_cross(p, x, enc, cfg), a


def run_stack(params, x, positions, cfg: ModelConfig, enc=None,
              collect_cache: bool = False):
    """All layers (each followed by its cross-attention over the encoder
    states `enc`, when given), then the final norm.  Returns (hidden, aux,
    caches): aux is the MoE load-balance loss summed over layers (0 for a
    dense model); caches is the per-layer list of decode caches of length
    t when `collect_cache` (prefill; None for a recurrent layer; an
    encoder-decoder layer's also holds its cross k and v over `enc`), else
    None."""
    caches = [] if collect_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, (kind, moe_layer) in zip(params["layers"], layer_plan(cfg)):
        if collect_cache:
            x, a, cache = blk.block_full(p, x, positions, cfg, kind, moe_layer,
                                         collect_cache=True)
            x = _apply_cross(p, x, enc, cfg)
            if enc is not None and "cross_attn" in p:
                cross = precompute_cross_kv(p["cross_attn"], enc)
                cache = dict(cache, cross_k=cross["k"], cross_v=cross["v"])
            caches.append(cache)
        elif cfg.remat == "full":
            x, a = checkpoint(_block, p, x, positions, enc, cfg, kind, moe_layer,
                              use_reentrant=False)
        elif cfg.remat == "tp_boundary":
            x, a = checkpoint_tp_boundary(_block, p, x, positions, enc, cfg,
                                          kind, moe_layer)
        else:
            x, a = _block(p, x, positions, enc, cfg, kind, moe_layer)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return x, aux, caches


# ------------------------------------------------------------------ loss ----

def _unembed_table(params, cfg: ModelConfig):
    return (params["embed"] if cfg.tie_embeddings else params["unembed"])["table"]


def _logits(params, hidden, cfg: ModelConfig, entered: bool = False):
    """Logits; under a vocab-sharded table this rank's columns (`entered`:
    `hidden` has passed the sequence-parallel entry already)."""
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    src = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(src, hidden, tied_table=tied, vocab=cfg.vocab_size,
                     entered=entered)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _xent(logits, labels):
    """Cross entropy with label -1 == masked. Returns (sum_loss, count)."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def _xent_vocab_parallel(logits, labels, v0: int):
    """`_xent` over this rank's vocab columns [v0, v0 + n): logz = max +
    log Σexp with the max and Σexp reduced over the model group, and the
    target logit from the one rank whose columns hold it."""
    mask = labels >= 0
    logits = logits.float()
    n = logits.shape[-1]
    top = tp_max(logits.max(dim=-1).values)
    logz = top + torch.log(tp_reduce(torch.exp(logits - top[..., None]).sum(-1)))
    local = labels.long() - v0
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp_reduce(gold * inside)
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def token_loss(params, hidden, labels, cfg: ModelConfig):
    """Masked mean cross-entropy, chunked over the sequence axis when
    `cfg.xent_chunk` divides it.  Under sequence parallelism `hidden` is
    this rank's slice of the stream, gathered here into whole rows: the
    vocab-parallel unembedding's entry (`stream_enter`), or, with a whole
    table, `stream_gather`."""
    shard = vocab_shard(_unembed_table(params, cfg), cfg.vocab_size)
    if shard is None:
        xent = _xent
    else:
        xent = lambda logits, lab: _xent_vocab_parallel(logits, lab, shard[0])
    entered = seq_parallel()
    if entered:
        with stream_length(labels.shape[1]):
            hidden = (stream_gather(hidden) if shard is None
                      else stream_enter(hidden))
    chunk = cfg.xent_chunk
    t = hidden.shape[1]
    if chunk <= 0 or t <= chunk or t % chunk != 0:
        s, c = xent(_logits(params, hidden, cfg, entered), labels)
        return s / torch.clamp(c, min=1)

    def body(hc, lc):
        with span("model.xent"):
            return xent(_logits(params, hc, cfg, entered), lc)

    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    c = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(t // chunk):
        ds, dc = checkpoint(body, hidden[:, i * chunk:(i + 1) * chunk],
                            labels[:, i * chunk:(i + 1) * chunk],
                            use_reentrant=False)
        s = s + ds
        c = c + dc
    return s / torch.clamp(c, min=1)


# ------------------------------------------------------------- model API ----

def _embed(params, tokens, cfg: ModelConfig, sliced: bool = False):
    x = embed_tokens(params["embed"], tokens, cfg.scale_embed, cfg.d_model,
                     vocab=cfg.vocab_size, sliced=sliced)
    return x.to(cfg.act_dtype)


def _assemble_inputs(params, batch, cfg: ModelConfig):
    """Embed the tokens and any stub-frontend input: a vision config's
    `patch_embeds` (b, np, d) go before the text; an audio config's
    `frames` (b, nf, d) go through the encoder.  Returns (x, positions,
    label_offset, enc).  Under sequence parallelism x is this rank's slice
    of the stream (module docstring); positions stay whole."""
    tokens = batch["tokens"]
    vision = cfg.frontend.kind == "vision_stub"
    sp = seq_parallel()
    x = _embed(params, tokens, cfg, sliced=sp and not vision)
    enc = None
    offset = 0
    if vision:
        patches = batch["patch_embeds"].to(cfg.act_dtype)
        x = torch.cat([patches, x], dim=1)
        offset = patches.shape[1]
    elif cfg.frontend.kind == "audio_stub":
        enc = encode(params, batch["frames"].to(cfg.act_dtype), cfg)
    b, t = tokens.shape[0], tokens.shape[1] + offset
    if cfg.pos_embed == "sinusoidal":
        pos = sinusoidal_positions(t, cfg.d_model, x.dtype, x.device)[None]
        x = x + (stream_scatter(pos) if sp and not vision else pos)
    if sp and vision:
        x = stream_scatter(x)
    return x, torch.arange(t, device=x.device).expand(b, t), offset, enc


def forward(params, batch, cfg: ModelConfig):
    """Full forward -> (hidden, aux, label_offset)."""
    x, positions, offset, enc = _assemble_inputs(params, batch, cfg)
    hidden, aux, _ = run_stack(params, x, positions, cfg, enc=enc)
    return hidden, aux, offset


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy plus the MoE aux loss (zero for dense
    models).  labels use -1 as mask; a vision prefix's positions carry no
    label."""
    hidden, aux, offset = forward(params, batch, cfg)
    labels = batch["labels"]
    if offset:
        pad = torch.full((labels.shape[0], offset), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = token_loss(params, hidden, labels, cfg)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(params, batch, cfg: ModelConfig):
    """Prefill for serving: returns (last-token logits (b, vocab), caches),
    caches the per-layer decode caches of length t, a vision prefix
    included (post-RoPE {"k", "v"}, MLA's {"c_kv", "k_rope"}; None for a
    recurrent layer, as in the reference; an encoder-decoder layer's with
    its cross k and v over the encoded `frames`)."""
    x, positions, _, enc = _assemble_inputs(params, batch, cfg)
    hidden, _, caches = run_stack(params, x, positions, cfg, enc=enc,
                                  collect_cache=True)
    logits = _whole_logits(params, _logits(params, hidden[:, -1:, :], cfg), cfg)
    return logits[:, 0], _cache_layout(caches, cfg)


def _whole_logits(params, logits, cfg: ModelConfig):
    """Logits over the whole vocab: under a vocab-sharded table, the
    ranks' columns all-gathered in model order."""
    if vocab_shard(_unembed_table(params, cfg), cfg.vocab_size) is None:
        return logits
    return tp_gather(logits, -1)


def _cache_layout(caches: list, cfg: ModelConfig) -> list:
    """Prefill's caches in `cache_pspecs`'s layout on a model axis: a
    self-attention cache whose kv heads stay whole (they do not divide the
    axis), or MLA's latents, cut to the rank's slice of the positions when
    `params.seq_sharded` says so."""
    tp = model_axis()
    if tp is None:
        return caches
    msize = model_size()

    def cut(x):
        n = x.shape[1] // msize
        return x.narrow(1, tp[1] * n, n)

    out = []
    for cache in caches:
        if cache is not None:
            keys = (("c_kv", "k_rope") if "c_kv" in cache else
                    ("k", "v") if cfg.num_kv_heads % msize else ())
            if keys and seq_sharded(cache[keys[0]].shape[1], msize):
                cache = dict(cache, **{k: cut(cache[k]) for k in keys})
        out.append(cache)
    return out


# ------------------------------------------------------------- decoding ----

def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      ring: bool = False, device=None) -> list:
    """Fresh decode cache, one per layer on `device` (default: the CUDA
    card): a zeroed {"k", "v"} of (batch, length, kv_heads, head_dim); for
    an MLA layer {"c_kv": (batch, length, kv_lora_rank), "k_rope":
    (batch, length, qk_rope_head_dim)}; for an RG-LRU layer {"h": (batch,
    lru_width) f32, "conv": (batch, conv_width - 1, lru_width)}; for an
    SSD layer {"ssm": (batch, heads, state, head_dim) f32, "conv": (batch,
    conv_width - 1, d_inner + 2 state)}.  An encoder-decoder layer's also
    holds "cross_k" and "cross_v" of (batch, num_frames, kv_heads,
    head_dim), zeros as the reference's cross caches start (prefill
    returns them filled over the encoded frames).  ring=True (the
    long_500k serving mode) bounds full-attention and MLA caches to
    cfg.long_context_window; local-attention caches are window-long rings
    by construction."""
    device = resolve_device(device)

    def length(kind):
        if ring and kind in (ATTN, MLA_ATTN):
            return min(cache_len, cfg.long_context_window)
        return cache_len

    def one(kind):
        cache = blk.init_block_cache(cfg, kind, batch, length(kind), cfg.act_dtype,
                                     device)
        if cfg.encoder is not None:
            shape = (batch, cfg.encoder.num_frames, cfg.num_kv_heads, cfg.head_dim)
            cache["cross_k"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
            cache["cross_v"] = torch.zeros(shape, dtype=cfg.act_dtype, device=device)
        return cache

    return [one(kind) for kind in layer_kinds(cfg)]


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                ring: bool = False, seq_shards=None):
    """One decode step.  tokens: (b,) integers; pos: a scalar global
    position or a (b,) tensor of per-row positions (continuous batching).
    The cache is updated IN PLACE.  `seq_shards`: per layer, whether its
    cache is this rank's slice of the positions (`serve_step`'s
    `layer_seq_shards`; None: no layer's is).  Returns (logits (b, vocab),
    cache), the logits whole on every rank of a model axis."""
    x = _embed(params, tokens[:, None], cfg)
    if cfg.pos_embed == "sinusoidal":
        emb = sinusoidal_at(pos, cfg.d_model, x.dtype, x.device)
        x = x + (emb[:, None, :] if emb.dim() == 2 else emb[None, None, :])
    for i, (p, (kind, moe_layer)) in enumerate(zip(params["layers"],
                                                   layer_plan(cfg))):
        x, cache[i] = blk.block_decode(p, x, cache[i], pos, cfg, kind,
                                       moe_layer, ring=ring,
                                       seq_sharded=bool(seq_shards and seq_shards[i]))
        if "cross_k" in cache[i]:
            x = _apply_cross(p, x, {"k": cache[i]["cross_k"],
                                    "v": cache[i]["cross_v"]}, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return _whole_logits(params, _logits(params, x, cfg)[:, 0], cfg), cache
