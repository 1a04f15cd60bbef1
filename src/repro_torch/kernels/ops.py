"""Public entry points of the port's kernels, dispatched by the device of
the tensors passed in (counterpart of `repro/kernels/ops.py`'s flat
hot-path dispatch):

* a CUDA tensor goes to the hand-written kernel — or the call raises;
* a CPU tensor goes to the kernel's plain PyTorch version in `ref.py`.

There is no environment override and no fallback: a tensor on the card
never reaches the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_adamw import adamw_scalars, fused_adamw_stats


def adamw_flat(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1, c2,
               clip_scale=1.0):
    """Flat-buffer AdamW over one bucket, IN PLACE on p, m and v (the port's
    form of the reference's buffer donation).  Returns (p, m, v, Σg²_raw)
    with Σg² a 0-d f32 tensor on p's device."""
    if p.device.type == "cuda":
        gsq = fused_adamw_stats(
            p, g, m, v, adamw_scalars(lr, c1, c2, clip_scale, p.device),
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
        return p, m, v, gsq
    if p.device.type != "cpu":
        raise ValueError(f"adamw_flat: no implementation for {p.device}")
    p2, m2, v2, gsq = ref.adamw_stats_ref(
        p, g, m, v, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, c1=c1, c2=c2, clip_scale=clip_scale)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v, gsq


def flat_dispatch_info(device) -> dict:
    """Which implementation the flat AdamW tail runs for tensors on
    `device`."""
    kind = torch.device(device).type
    return {"device": str(device),
            "flat_tail": {"cuda": "cuda-kernel fused_adamw_stats",
                          "cpu": "torch-reference"}.get(kind, "unsupported")}
