"""Decoder-only transformer stack: init, forward, masked cross-entropy
with the MoE aux loss, prefill and KV-cache decode (counterpart of
`repro/models/transformer.py`, decoder subset).

The reference scans stacked per-layer parameters (`blocks`, a leading
repeat axis) after unscanned `prefix_blocks`; the port keeps one parameter
dict per layer in `layers`, in execution order, and runs a Python loop.
Likewise the decode cache is a list with one cache per layer ({"k", "v"},
or MLA's {"c_kv", "k_rope"}), where the reference stacks `scanned` caches.
`models/convert.py` maps between the two layouts.

Cross-entropy can run in sequence chunks (`cfg.xent_chunk`), each chunk's
logits recomputed in the backward pass, so the (batch, seq, vocab) logits
tensor is never materialized whole.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as blk
from repro_torch.models.common import resolve_device
from repro_torch.models.config import ATTN, MLA_ATTN, ModelConfig
from repro_torch.models.embeddings import init_embedding, embed_tokens, unembed
from repro_torch.models.norms import init_norm, apply_norm


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

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters: normal(0, 0.02) weights, unit norm scales, drawn
    from a `torch.Generator` seeded with `seed` on `device` (default: the
    CUDA card; raises when there is none)."""
    blk.check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.p_dtype, device)}
    params["layers"] = [blk.init_block(gen, cfg, kind, moe_layer, device)
                        for kind, moe_layer in layer_plan(cfg)]
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_kind, cfg.p_dtype,
                                     device)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.p_dtype, device)
    return params


# ----------------------------------------------------------------- stack ----

def _block(p, x, positions, cfg, kind, moe_layer):
    return blk.block_full(p, x, positions, cfg, kind, moe_layer)[:2]


def run_stack(params, x, positions, cfg: ModelConfig,
              collect_cache: bool = False):
    """All layers, then the final norm.  Returns (hidden, aux, caches):
    aux is the MoE load-balance loss summed over layers (0 for a dense
    model); caches is the per-layer list of decode caches of length t
    when `collect_cache` (prefill), else None."""
    caches = [] if collect_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, (kind, moe_layer) in zip(params["layers"], layer_plan(cfg)):
        if collect_cache:
            x, a, cache = blk.block_full(p, x, positions, cfg, kind, moe_layer,
                                         collect_cache=True)
            caches.append(cache)
        elif cfg.remat == "full":
            x, a = checkpoint(_block, p, x, positions, cfg, kind, moe_layer,
                              use_reentrant=False)
        else:
            x, a = _block(p, x, positions, cfg, kind, moe_layer)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return x, aux, caches


# ------------------------------------------------------------------ loss ----

def _logits(params, hidden, cfg: ModelConfig):
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    src = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(src, hidden, tied_table=tied)
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


def token_loss(params, hidden, labels, cfg: ModelConfig):
    """Masked mean cross-entropy, chunked over the sequence axis when
    `cfg.xent_chunk` divides it."""
    chunk = cfg.xent_chunk
    t = hidden.shape[1]
    if chunk <= 0 or t <= chunk or t % chunk != 0:
        s, c = _xent(_logits(params, hidden, cfg), labels)
        return s / torch.clamp(c, min=1)

    def body(hc, lc):
        return _xent(_logits(params, hc, cfg), lc)

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

def _embed(params, tokens, cfg: ModelConfig):
    x = embed_tokens(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
    return x.to(cfg.act_dtype)


def _assemble_inputs(params, batch, cfg: ModelConfig):
    """(x, positions) of a full-sequence batch."""
    x = _embed(params, batch["tokens"], cfg)
    b, t = x.shape[:2]
    return x, torch.arange(t, device=x.device).expand(b, t)


def forward(params, batch, cfg: ModelConfig):
    """Full forward -> (hidden, aux)."""
    hidden, aux, _ = run_stack(params, *_assemble_inputs(params, batch, cfg), cfg)
    return hidden, aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy plus the MoE aux loss (zero for dense
    models).  labels use -1 as mask."""
    hidden, aux = forward(params, batch, cfg)
    loss = token_loss(params, hidden, batch["labels"], cfg)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(params, batch, cfg: ModelConfig):
    """Prefill for serving: returns (last-token logits (b, vocab), caches),
    caches the per-layer decode caches of length t (post-RoPE {"k", "v"},
    MLA's {"c_kv", "k_rope"})."""
    hidden, _, caches = run_stack(params, *_assemble_inputs(params, batch, cfg),
                                  cfg, collect_cache=True)
    logits = _logits(params, hidden[:, -1:, :], cfg)
    return logits[:, 0], caches


# ------------------------------------------------------------- decoding ----

def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      ring: bool = False, device=None) -> list:
    """Fresh decode cache, one per layer on `device` (default: the CUDA
    card): a zeroed {"k", "v"} of (batch, length, kv_heads, head_dim), or
    for an MLA layer {"c_kv": (batch, length, kv_lora_rank), "k_rope":
    (batch, length, qk_rope_head_dim)}.  ring=True (the long_500k serving
    mode) bounds full-attention and MLA caches to cfg.long_context_window;
    local-attention caches are window-long rings by construction."""
    device = resolve_device(device)

    def length(kind):
        if ring and kind in (ATTN, MLA_ATTN):
            return min(cache_len, cfg.long_context_window)
        return cache_len

    return [blk.init_block_cache(cfg, kind, batch, length(kind), cfg.act_dtype,
                                 device)
            for kind in layer_kinds(cfg)]


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                ring: bool = False):
    """One decode step.  tokens: (b,) integers; pos: a scalar global
    position or a (b,) tensor of per-row positions (continuous batching).
    The cache is updated IN PLACE.  Returns (logits (b, vocab), cache)."""
    x = _embed(params, tokens[:, None], cfg)
    for i, (p, (kind, moe_layer)) in enumerate(zip(params["layers"],
                                                   layer_plan(cfg))):
        x, cache[i] = blk.block_decode(p, x, cache[i], pos, cfg, kind,
                                       moe_layer, ring=ring)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return _logits(params, x, cfg)[:, 0], cache
