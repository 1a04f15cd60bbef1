"""Dense MLP variants: SwiGLU / GeGLU / GELU / squared-ReLU (counterpart of
`repro/models/mlp.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def apply_mlp(params, x, kind: str):
    if kind in ("swiglu", "geglu"):
        gate = torch.einsum("btd,df->btf", x, params["w_gate"].to(x.dtype))
        up = torch.einsum("btd,df->btf", x, params["w_up"].to(x.dtype))
        act = F.silu(gate) if kind == "swiglu" else _gelu(gate)
        h = act * up
    else:
        h = torch.einsum("btd,df->btf", x, params["w_up"].to(x.dtype))
        if kind == "gelu":
            h = _gelu(h)
        elif kind == "relu2":
            h = torch.square(F.relu(h))
        else:
            raise ValueError(kind)
    return torch.einsum("btf,fd->btd", h, params["w_down"].to(x.dtype))
