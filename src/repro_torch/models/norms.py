"""RMSNorm / LayerNorm on plain parameter dicts (counterpart of
`repro/models/norms.py`): statistics in f32, result cast back to x's dtype.

RMSNorm with grad mode off (serving, under `torch.inference_mode()`, and
the training loop's eval loss under `torch.no_grad`) goes through the
kernel's entry point `kernels.ops.rmsnorm`: on the card it runs the CUDA
kernel, which divides by sqrt(var + eps) as the TPU kernel does, and on
the CPU the plain code below, which multiplies by 1 / sqrt(var + eps) as
the reference model does (the two differ by an ulp or so).  Training,
which needs a backward, runs the plain code on every device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ones_init, zeros_init


def init_norm(d: int, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": ones_init((d,), dtype, device)}
    if kind == "layernorm":
        return {"scale": ones_init((d,), dtype, device),
                "bias": zeros_init((d,), dtype, device)}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    if kind == "rmsnorm" and not torch.is_grad_enabled():
        # the kernel's entry point on every device: the card launches
        # rmsnorm, another device runs the plain code below
        return ops.rmsnorm(x.contiguous(), params["scale"], eps,
                           plain=lambda: _plain_norm(params, x, kind, eps))
    return _plain_norm(params, x, kind, eps)


def _plain_norm(params, x, kind: str, eps: float):
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * (1.0 / torch.sqrt(var + eps))
        y = y * params["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return y.to(dtype)
