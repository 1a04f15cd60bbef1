"""Decoder-only transformer stack: init, forward, masked cross-entropy
(counterpart of `repro/models/transformer.py`, dense decoder subset).

The reference scans stacked per-layer parameters (`blocks`, a leading
repeat axis); the port keeps one parameter dict per layer in `layers` and
runs a Python loop.  `models/convert.py` maps between the two layouts.

Cross-entropy can run in sequence chunks (`cfg.xent_chunk`), each chunk's
logits recomputed in the backward pass, so the (batch, seq, vocab) logits
tensor is never materialized whole.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as blk
from repro_torch.models.config import ModelConfig
from repro_torch.models.embeddings import init_embedding, embed_tokens, unembed
from repro_torch.models.norms import init_norm, apply_norm


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """Kind of every layer in execution order (prefix, then the repeats of
    the block pattern)."""
    return cfg.prefix_pattern + cfg.block_pattern * cfg.num_repeats


# ------------------------------------------------------------------ init ----

def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random parameters: normal(0, 0.02) weights, unit norm scales, drawn
    from a `torch.Generator` seeded with `seed` on `device`."""
    blk.check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.p_dtype, device)}
    params["layers"] = [blk.init_block(gen, cfg, kind, device)
                        for kind in layer_kinds(cfg)]
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_kind, cfg.p_dtype,
                                     device)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.p_dtype, device)
    return params


# ----------------------------------------------------------------- stack ----

def run_stack(params, x, positions, cfg: ModelConfig):
    """All layers, then the final norm.  Returns (hidden, aux)."""
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        if cfg.remat == "full":
            x = checkpoint(blk.block_full, p, x, positions, cfg, kind,
                           use_reentrant=False)
        else:
            x = blk.block_full(p, x, positions, cfg, kind)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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

def forward(params, batch, cfg: ModelConfig):
    """Full forward -> (hidden, aux)."""
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
    x = x.to(cfg.act_dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device).expand(b, t)
    return run_stack(params, x, positions, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy (+ aux, zero for dense models).
    labels use -1 as mask."""
    hidden, aux = forward(params, batch, cfg)
    loss = token_loss(params, hidden, batch["labels"], cfg)
    return loss + aux, {"xent": loss, "aux": aux}
