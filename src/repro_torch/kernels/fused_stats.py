"""CUDA kernel: the norm test's fused statistics pair (Σ(x−y)², Σy²) in one
read of each operand (DESIGN §9).

Replaces the TPU kernel `fused_stats` of `repro/kernels/fused_stats.py`.
FSDP-Norm calls it once per flat bucket per step with x = g_j (the
worker's gradient) and y = g (the mean gradient): ‖g_j − g‖² and ‖g‖².
The source, with its design and bound, is `csrc/fused_stats.cu`; the plain
version is `ref.fused_stats_ref`.

The wrapper takes CUDA tensors only (`kernels.ops` dispatches by device)
and raises on anything the kernel does not take.  Each call adds one to
`fused_stats.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, check_operands, grid_for, load

SOURCE = "fused_stats"       # one source for fused_stats and sqdiff_norm


def stats_lib():
    """The library of `csrc/fused_stats.cu`, its two entry points bound."""
    lib = load(SOURCE)
    if lib.repro_fused_stats.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.repro_fused_stats, lib.repro_sqdiff_norm):
            fn.argtypes = [vp, i, vp, i, vp, vp, ctypes.c_longlong, i, vp]
            fn.restype = ctypes.c_int
    return lib


def launch_stats(kernel: str, x, y, outputs: int) -> torch.Tensor:
    """Check x and y, launch `kernel` of the stats library and return its
    `outputs` f32 sums as a 1-D tensor on the device."""
    check_operands(kernel, x.device, {"x": x, "y": y})
    if x.shape != y.shape:
        raise ValueError(f"{kernel}: x and y differ in shape: "
                         f"{tuple(x.shape)} vs {tuple(y.shape)}")
    lib = stats_lib()
    n = x.numel()
    grid = grid_for(n)
    partials = torch.empty(outputs * grid, dtype=torch.float32, device=x.device)
    out = torch.empty(outputs, dtype=torch.float32, device=x.device)
    err = getattr(lib, f"repro_{kernel}")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
        int(y.dtype == torch.bfloat16), partials.data_ptr(), out.data_ptr(),
        n, grid, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, err, kernel)
    return out


def fused_stats(x, y):
    """(Σ(x−y)², Σy²) as two 0-d f32 tensors on the device; x and y are
    float32 or bfloat16 (each its own) and of the same shape."""
    out = launch_stats("fused_stats", x, y, 2)
    fused_stats.launches += 1
    return out[0], out[1]


fused_stats.launches = 0
