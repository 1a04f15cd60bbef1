"""Dense MLP variants: SwiGLU / GeGLU / GELU / squared-ReLU (counterpart of
`repro/models/mlp.py`).

Tensor parallelism: when `w_up` holds fewer columns than the config's
`d_ff`, the leaves are this rank's ffn shard; the input enters through
`stream_enter` and `w_down`'s partial sum is made whole by `maybe_shard`
at the reference's exit (under sequence parallelism: the stream's slices
all-gathered at the entry, the sum reduce-scattered at the exit).  Whole
leaves on a sequence-parallel stream run on the gathered rows, and the
rank keeps its slice of the result.  The products against the weights go
through `kernels.ops.dense` (the split-TF32 GEMM kernel for f32 on the card
with at least 64 rows, else the einsum)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, stream_enter, stream_gather, stream_scatter)
from repro_torch.kernels import ops
from repro_torch.models.common import normal_init


def init_mlp(gen, d_model: int, d_ff: int, kind: str, dtype, device):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": normal_init(gen, (d_model, d_ff), dtype, device),
            "w_up": normal_init(gen, (d_model, d_ff), dtype, device),
            "w_down": normal_init(gen, (d_ff, d_model), dtype, device),
        }
    if kind in ("gelu", "relu2"):
        return {
            "w_up": normal_init(gen, (d_model, d_ff), dtype, device),
            "w_down": normal_init(gen, (d_ff, d_model), dtype, device),
        }
    raise ValueError(kind)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, kind: str, d_ff: int | None = None):
    sharded = (d_ff is not None and params["w_up"].shape[1] != d_ff
               and model_axis() is not None)
    x = stream_enter(x) if sharded else stream_gather(x)
    if kind in ("swiglu", "geglu"):
        gate = ops.dense("btd,df->btf", x, params["w_gate"].to(x.dtype))
        up = ops.dense("btd,df->btf", x, params["w_up"].to(x.dtype))
        act = F.silu(gate) if kind == "swiglu" else _gelu(gate)
        h = act * up
    else:
        h = ops.dense("btd,df->btf", x, params["w_up"].to(x.dtype))
        if kind == "gelu":
            h = _gelu(h)
        elif kind == "relu2":
            h = torch.square(F.relu(h))
        else:
            raise ValueError(kind)
    out = ops.dense("btf,fd->btd", h, params["w_down"].to(x.dtype))
    return (maybe_shard(out, "batch", "seq", "embed") if sharded
            else stream_scatter(out))
