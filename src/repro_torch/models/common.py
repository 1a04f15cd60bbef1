"""Shared helpers for model layers: initializers and parameter counting.

Counterpart of `repro/models/common.py`.  Initializers draw from an
explicit `torch.Generator`; `jax.random` streams cannot be reproduced in
torch, so parity with the reference always goes through
`models.convert.params_from_jax`.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when none is given; raises when no
    device is given and there is no card (entry points run on the card
    unless the caller asks for the CPU)."""
    if device is not None and str(device):
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return torch.device("cuda")


def normal_init(gen: torch.Generator, shape, dtype, device,
                stddev: float = 0.02) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(0.0, stddev, generator=gen)
    return x.to(dtype)


def ones_init(shape, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def zeros_init(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def count_params(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
