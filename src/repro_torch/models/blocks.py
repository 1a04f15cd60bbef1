"""Decoder block: dispatch over layer kinds (attn / local / mla / rglru /
ssd), pre/post norms, dense-MLP or MoE feed-forward, residuals
(counterpart of `repro/models/blocks.py`):

* `block_full(params, x, positions, cfg, kind, moe_layer, causal,
  collect_cache)` -> (x, aux, cache | None)      # training / prefill
* `block_decode(params, x, cache, pos, cfg, kind, moe_layer, ring,
  seq_sharded)`
      -> (x, cache)                             # one token a row
* `init_block`, `init_block_cache`

An SSD block has no feed-forward sub-layer, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import stream_length
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.config import (
    ModelConfig, ATTN, LOCAL_ATTN, MLA_ATTN, RGLRU, SSD)
from repro_torch.models.mlp import init_mlp, apply_mlp
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.norms import init_norm, apply_norm


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for any part of `cfg` the port does not
    implement: a remat policy other than the reference's none, full and
    tp_boundary."""
    if cfg.remat not in ("none", "full", "tp_boundary"):
        raise NotImplementedError(f"{cfg.name}: remat={cfg.remat!r}")


def has_mlp(cfg: ModelConfig, kind: str) -> bool:
    return cfg.mlp_kind != "none" and kind != SSD


def init_block(gen, cfg: ModelConfig, kind: str, moe_layer: bool, device):
    d, dtype = cfg.d_model, cfg.p_dtype
    p = {"pre_norm": init_norm(d, cfg.norm_kind, dtype, device)}
    if kind in (ATTN, LOCAL_ATTN):
        p["attn"] = attn_lib.init_attention(gen, d, cfg.num_heads,
                                            cfg.num_kv_heads, cfg.head_dim,
                                            dtype, device)
    elif kind == MLA_ATTN:
        p["attn"] = mla_lib.init_mla(gen, d, cfg.num_heads, cfg.mla, dtype,
                                     device)
    elif kind == RGLRU:
        p["rec"] = rglru_lib.init_rglru(gen, d, cfg.rglru, dtype, device)
    elif kind == SSD:
        p["ssd"] = ssd_lib.init_ssd(gen, d, cfg.ssm, dtype, device)
    else:
        raise ValueError(kind)
    if cfg.post_attn_norm:
        p["post_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
    if has_mlp(cfg, kind):
        p["mlp_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
        p["mlp"] = (init_moe(gen, d, cfg.moe, dtype, device) if moe_layer
                    else init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device))
        if cfg.post_attn_norm:
            p["post_mlp_norm"] = init_norm(d, cfg.norm_kind, dtype, device)
    return p


def _rope_theta(cfg: ModelConfig) -> float:
    return cfg.rope_theta if cfg.pos_embed == "rope" else 0.0


def block_full(params, x, positions, cfg: ModelConfig, kind: str,
               moe_layer: bool = False, causal: bool = True,
               collect_cache: bool = False):
    """Returns (x, aux, cache): aux is the MoE load-balance loss (0 for a
    dense layer); cache, when `collect_cache`, is the layer's decode cache
    of length t — post-RoPE {"k", "v"}, or MLA's {"c_kv", "k_rope"}; None
    for a recurrent layer, whose prefill state the reference does not
    collect either — else None.  Under sequence parallelism x and the
    result are this rank's slice of the stream, whose true length is
    `positions`' (`distributed/sharding.py`)."""
    with stream_length(positions.shape[-1]):
        return _block_full(params, x, positions, cfg, kind, moe_layer, causal,
                           collect_cache)


def _block_full(params, x, positions, cfg, kind, moe_layer, causal,
                collect_cache):
    h = apply_norm(params["pre_norm"], x, cfg.norm_kind)
    cache = None
    if kind == RGLRU:
        mixed = rglru_lib.rglru_block(params["rec"], h, cfg.rglru)
    elif kind == SSD:
        mixed = ssd_lib.ssd_block(params["ssd"], h, cfg.ssm)
    elif kind == MLA_ATTN:
        mixed = mla_lib.mla_full(params["attn"], h, positions, cfg.mla,
                                 causal=causal, return_latents=collect_cache,
                                 num_heads=cfg.num_heads)
        if collect_cache:
            mixed, c_kv, k_rope = mixed
            cache = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        window = cfg.sliding_window if kind == LOCAL_ATTN else 0
        mixed = attn_lib.attend_full(
            params["attn"], h, positions, rope_theta=_rope_theta(cfg),
            softcap=cfg.attn_logit_softcap, window=window, causal=causal,
            qk_norm=cfg.qk_norm, return_kv=collect_cache,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
        if collect_cache:
            mixed, k, v = mixed
            cache = {"k": k, "v": v}
    x, aux = _block_tail(params, x, mixed, cfg, kind, moe_layer,
                         capacity_factor=None)
    return x, aux, cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype, device):
    if kind == MLA_ATTN:
        return mla_lib.init_mla_cache(batch, cache_len, cfg.mla, dtype, device)
    if kind == RGLRU:
        return rglru_lib.init_rglru_state(batch, cfg.d_model, cfg.rglru, dtype,
                                          device)
    if kind == SSD:
        return ssd_lib.init_ssd_state(batch, cfg.d_model, cfg.ssm, dtype, device)
    if kind not in (ATTN, LOCAL_ATTN):
        raise ValueError(kind)
    length = min(cache_len, cfg.sliding_window) if kind == LOCAL_ATTN \
        else cache_len
    return attn_lib.init_cache(batch, length, cfg.num_kv_heads, cfg.head_dim,
                               dtype, device)


def block_decode(params, x, cache, pos, cfg: ModelConfig, kind: str,
                 moe_layer: bool = False, ring: bool = False,
                 seq_sharded: bool = False):
    """One token a row; the cache is updated in place.  Returns (x, cache).
    An MoE layer dispatches each row's one token at capacity factor
    max(2, cfg's), as the reference does, so no pair drops.  The mixers
    take the config's head counts, as in `block_full`, so leaves with
    fewer are this rank's shard; `seq_sharded`: an attention or MLA cache
    that is this rank's slice of the positions (`attention` case (c))."""
    h = apply_norm(params["pre_norm"], x, cfg.norm_kind)
    if kind == RGLRU:
        mixed, cache = rglru_lib.rglru_decode(params["rec"], h, cache, cfg.rglru)
    elif kind == SSD:
        mixed, cache = ssd_lib.ssd_decode(params["ssd"], h, cache, cfg.ssm)
    elif kind == MLA_ATTN:
        mixed, cache = mla_lib.mla_decode(params["attn"], h, cache, pos,
                                          cfg.mla, ring=ring,
                                          num_heads=cfg.num_heads,
                                          seq_sharded=seq_sharded)
    elif kind in (ATTN, LOCAL_ATTN):
        # local-attn caches are rings by construction (length == window)
        mixed, cache = attn_lib.attend_decode(
            params["attn"], h, cache, pos, rope_theta=_rope_theta(cfg),
            softcap=cfg.attn_logit_softcap, ring=ring or kind == LOCAL_ATTN,
            qk_norm=cfg.qk_norm, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, seq_sharded=seq_sharded)
    else:
        raise ValueError(kind)
    capacity = max(2.0, cfg.moe.capacity_factor) if moe_layer else None
    return _block_tail(params, x, mixed, cfg, kind, moe_layer,
                       capacity_factor=capacity)[0], cache


def _block_tail(params, x, mixed, cfg: ModelConfig, kind: str, moe_layer: bool,
                capacity_factor):
    """Post-mixer norm, residual, dense MLP or MoE (with its norms; none
    after an SSD mixer), residual.  Returns (x, aux).  Under sequence
    parallelism every step here runs on this rank's slice of the stream:
    the mixer and the feed-forward leave through their reduce-scatters."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_attn_norm:
        mixed = apply_norm(params["post_norm"], mixed, cfg.norm_kind)
    # the reference's first `act_seq` point (`maybe_shard(mixed, "batch",
    # "act_seq", "embed")`): `mixed` is this rank's slice
    x = x + mixed
    if has_mlp(cfg, kind):
        h = apply_norm(params["mlp_norm"], x, cfg.norm_kind)
        if moe_layer:
            h, aux = moe_apply(params["mlp"], h, cfg.moe,
                               capacity_factor=capacity_factor)
        else:
            h = apply_mlp(params["mlp"], h, cfg.mlp_kind, d_ff=cfg.d_ff)
        if cfg.post_attn_norm:
            h = apply_norm(params["post_mlp_norm"], h, cfg.norm_kind)
        # the reference's second `act_seq` point
        x = x + h
    return x, aux
