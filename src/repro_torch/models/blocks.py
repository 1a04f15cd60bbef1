"""Dense decoder block: pre/post norms, attention, dense MLP, residuals
(the dense subset of `repro/models/blocks.py`):

* `block_full(params, x, positions, cfg, kind, causal, collect_cache)`
      -> (x, cache | None)                      # training / prefill
* `block_decode(params, x, cache, pos, cfg, kind, ring)`
      -> (x, cache)                             # one token a row
* `init_block`, `init_block_cache`
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig, ATTN, LOCAL_ATTN
from repro_torch.models.mlp import init_mlp, apply_mlp
from repro_torch.models.norms import init_norm, apply_norm

LATER = {
    "mla": "MLA attention arrives with the remaining-architectures slice",
    "rglru": "RG-LRU blocks arrive with the remaining-architectures slice",
    "ssd": "SSD (Mamba-2) blocks arrive with the remaining-architectures slice",
    "moe": "MoE feed-forward arrives with the remaining-architectures slice",
}


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for any part of `cfg` the port's dense
    decoder does not implement yet, naming the slice that brings it."""
    for kind in cfg.prefix_pattern + cfg.block_pattern:
        if kind not in (ATTN, LOCAL_ATTN):
            raise NotImplementedError(f"{cfg.name}: {LATER[kind]}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {LATER['moe']}")
    if cfg.encoder is not None or cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder and modality frontends arrive with the "
            "remaining-architectures slice")
    if cfg.pos_embed not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos_embed} positions arrive with the "
            "remaining-architectures slice")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"{cfg.name}: remat={cfg.remat!r}")


def init_block(gen, cfg: ModelConfig, kind: str, device):
    d, dtype = cfg.d_model, cfg.p_dtype
    p = {"pre_norm": init_norm(d, cfg.norm_kind, dtype, device),
         "attn": attn_lib.init_attention(gen, d, cfg.num_heads,
                                         cfg.num_kv_heads, cfg.head_dim,
                                         dtype, device)}
    if cfg.post_attn_norm:
        p["post_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
    if cfg.mlp_kind != "none":
        p["mlp_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device)
        if cfg.post_attn_norm:
            p["post_mlp_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
    return p


def _check_kind(cfg: ModelConfig, kind: str):
    if kind not in (ATTN, LOCAL_ATTN):
        raise NotImplementedError(f"{cfg.name}: {LATER[kind]}")


def _rope_theta(cfg: ModelConfig) -> float:
    return cfg.rope_theta if cfg.pos_embed == "rope" else 0.0


def block_full(params, x, positions, cfg: ModelConfig, kind: str,
               causal: bool = True, collect_cache: bool = False):
    """Returns (x, cache): cache is the layer's post-RoPE {"k", "v"} when
    `collect_cache`, else None."""
    h = apply_norm(params["pre_norm"], x, cfg.norm_kind)
    window = cfg.sliding_window if kind == LOCAL_ATTN else 0
    mixed = attn_lib.attend_full(
        params["attn"], h, positions, rope_theta=_rope_theta(cfg),
        softcap=cfg.attn_logit_softcap, window=window, causal=causal,
        qk_norm=cfg.qk_norm, return_kv=collect_cache)
    cache = None
    if collect_cache:
        mixed, k, v = mixed
        cache = {"k": k, "v": v}
    return _block_tail(params, x, mixed, cfg), cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype, device):
    _check_kind(cfg, kind)
    length = min(cache_len, cfg.sliding_window) if kind == LOCAL_ATTN \
        else cache_len
    return attn_lib.init_cache(batch, length, cfg.num_kv_heads, cfg.head_dim,
                               dtype, device)


def block_decode(params, x, cache, pos, cfg: ModelConfig, kind: str,
                 ring: bool = False):
    """One token a row; the cache is updated in place.  Returns (x, cache)."""
    _check_kind(cfg, kind)
    h = apply_norm(params["pre_norm"], x, cfg.norm_kind)
    # local-attn caches are rings by construction (length == window)
    mixed, cache = attn_lib.attend_decode(
        params["attn"], h, cache, pos, rope_theta=_rope_theta(cfg),
        softcap=cfg.attn_logit_softcap, ring=ring or kind == LOCAL_ATTN,
        qk_norm=cfg.qk_norm)
    return _block_tail(params, x, mixed, cfg), cache


def _block_tail(params, x, mixed, cfg: ModelConfig):
    """Post-attention norm, residual, MLP (with its norms), residual."""
    if cfg.post_attn_norm:
        mixed = apply_norm(params["post_norm"], mixed, cfg.norm_kind)
    x = x + mixed
    if cfg.mlp_kind != "none":
        h = apply_norm(params["mlp_norm"], x, cfg.norm_kind)
        h = apply_mlp(params["mlp"], h, cfg.mlp_kind)
        if cfg.post_attn_norm:
            h = apply_norm(params["post_mlp_norm"], h, cfg.norm_kind)
        x = x + h
    return x
