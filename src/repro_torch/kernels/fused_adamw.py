"""CUDA kernel: fused flat-buffer AdamW + pre-clip Σg² (Algorithm 1's
optimizer block, DESIGN §9).

Replaces the TPU kernel `fused_adamw_stats` of
`repro/kernels/fused_adamw.py`.  The source, with its design and bound, is
`csrc/fused_adamw.cu`; the plain version is `ref.adamw_stats_ref`.

The wrapper takes CUDA tensors only (`kernels.ops.adamw_flat` dispatches by
device) and raises on anything the kernel does not take.  p, m and v are
updated IN PLACE — the port's form of the reference step donating its
buffers.  Each call launches the kernel once (plus its fixed-order partial
sum) and adds one to `fused_adamw_stats.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import load

SOURCE = "fused_adamw"
_THREADS = 256
_PER_BLOCK = _THREADS * 4 * 4        # elements a block covers at full grid
_MAX_GRID = 2048


def grid_for(n: int) -> int:
    """Blocks for an n-element buffer: ~4096 elements each, at most 2048
    (about two waves of 8 resident 256-thread blocks on 132 SMs)."""
    return max(1, min(-(-n // _PER_BLOCK), _MAX_GRID))


def _lib():
    lib = load(SOURCE)
    fn = lib.repro_fused_adamw_stats
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, i, vp, i, vp, vp, vp, vp, vp, ctypes.c_longlong, i,
                       f, f, f, f, f, f, vp]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def adamw_scalars(lr, c1, c2, clip_scale, device) -> torch.Tensor:
    """The kernel's per-step scalars (lr, c1, c2, clip_scale) as one
    4-element f32 tensor on `device`; tensor inputs stay on the device (no
    host synchronisation)."""
    return torch.stack([torch.as_tensor(x, dtype=torch.float32).to(device).reshape(())
                        for x in (lr, c1, c2, clip_scale)])


def _check(p, g, m, v, scalars):
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("scalars", scalars)):
        if t.device.type != "cuda" or t.device != p.device:
            raise ValueError(f"fused_adamw_stats: {name} must lie on the CUDA "
                             f"device of p ({p.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw_stats: {name} must be contiguous")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_adamw_stats: p must be float32 or bfloat16, got {p.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_adamw_stats: g must be float32 or bfloat16, got {g.dtype}")
    for name, t in (("m", m), ("v", v), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adamw_stats: {name} must be float32, got {t.dtype}")
    if not p.numel() == g.numel() == m.numel() == v.numel():
        raise ValueError("fused_adamw_stats: p, g, m, v differ in size: "
                         f"{p.numel()}, {g.numel()}, {m.numel()}, {v.numel()}")
    if scalars.numel() != 4:
        raise ValueError("fused_adamw_stats: scalars must hold (lr, c1, c2, clip)")


def fused_adamw_stats(p, g, m, v, scalars, *, beta1: float, beta2: float,
                      eps: float, weight_decay: float) -> torch.Tensor:
    """In-place AdamW over one flat buffer; returns Σg² of the RAW gradient
    as a 0-d f32 tensor on the device.  `scalars` is `adamw_scalars(...)`."""
    _check(p, g, m, v, scalars)
    lib = _lib()
    n = p.numel()
    grid = grid_for(n)
    partials = torch.empty(grid, dtype=torch.float32, device=p.device)
    gsq = torch.empty((), dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.repro_fused_adamw_stats(
        p.data_ptr(), int(p.dtype == torch.bfloat16), g.data_ptr(),
        int(g.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), partials.data_ptr(), gsq.data_ptr(), n, grid,
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps, weight_decay, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adamw_stats launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})")
    fused_adamw_stats.launches += 1
    return gsq


fused_adamw_stats.launches = 0
