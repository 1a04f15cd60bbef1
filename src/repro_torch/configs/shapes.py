"""Assigned input shapes and meta-tensor stand-ins for the dry-run
(counterpart of `repro/configs/shapes.py`).

The FULL configs are exercised only through these specs (no allocation):
where the reference returns `jax.ShapeDtypeStruct`s, these are tensors on
the "meta" device, which carry a shape and a dtype and no storage.  Smoke
tests instantiate reduced variants.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

_i32 = torch.int32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int, seq: int):
    """Stub-frontend embeddings + adjusted text length (see DESIGN §4)."""
    extra = {}
    text_len = seq
    if cfg.frontend.kind == "vision_stub":
        np_ = cfg.frontend.num_prefix_tokens
        extra["patch_embeds"] = _meta((batch, np_, cfg.d_model), cfg.act_dtype)
        text_len = seq - np_
    elif cfg.frontend.kind == "audio_stub":
        extra["frames"] = _meta((batch, cfg.encoder.num_frames, cfg.d_model),
                                cfg.act_dtype)
    return extra, text_len


def train_inputs(cfg: ModelConfig, shape: InputShape, accum: int = 1):
    """Stacked microbatches partitioning the global batch:
    (M, global_batch/M, seq) token/label specs."""
    assert shape.global_batch % accum == 0, (shape, accum)
    b, s = shape.global_batch // accum, shape.seq_len
    extra, text_len = _frontend_specs(cfg, b, s)
    batch = {
        "tokens": _meta((accum, b, text_len), _i32),
        "labels": _meta((accum, b, text_len), _i32),
    }
    for k, v in extra.items():
        batch[k] = _meta((accum,) + tuple(v.shape), v.dtype)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    extra, text_len = _frontend_specs(cfg, b, s)
    batch = {"tokens": _meta((b, text_len), _i32)}
    batch.update(extra)
    return batch


def decode_inputs(cfg: ModelConfig, shape: InputShape):
    """(tokens, pos, cache) specs for one decode step with a seq_len cache:
    the cache is the port's per-layer list (`init_decode_cache` on the
    meta device)."""
    b, s = shape.global_batch, shape.seq_len
    ring = (shape.name == "long_500k") and not cfg.native_subquadratic
    return {
        "tokens": _meta((b,), _i32),
        "pos": _meta((), _i32),
        "cache": tfm.init_decode_cache(cfg, b, s, ring=ring, device="meta"),
        "ring": ring,
    }


def input_specs(cfg: ModelConfig, shape_name: str, accum: int = 1):
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return train_inputs(cfg, shape, accum)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape)
    return decode_inputs(cfg, shape)
