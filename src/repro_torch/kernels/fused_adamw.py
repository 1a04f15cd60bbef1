"""CUDA kernels: fused AdamW (Algorithm 1's optimizer block, DESIGN §9).

* `fused_adamw_stats` replaces the TPU kernel of the same name in
  `repro/kernels/fused_adamw.py`: AdamW over one flat buffer with the
  global-norm clip folded in and the pre-clip Σg² as a byproduct (plain
  version `ref.adamw_stats_ref`).
* `fused_adamw` replaces the TPU kernel `fused_adamw` there: the same
  update on one tensor of any shape, no clip, no byproduct (plain version
  `ref.adamw_ref`).

Both run the one element loop of `csrc/fused_adamw.cu`, whose header gives
the design and the bound.  The wrappers take CUDA tensors only
(`kernels.ops` dispatches by device) and raise on anything the kernel does
not take.  p, m and v are updated IN PLACE — the port's form of the
reference step donating its buffers.  Each call adds one to its wrapper's
`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, check_operands, grid_for, load

SOURCE = "fused_adamw"


def _lib():
    lib = load(SOURCE)
    if lib.repro_fused_adamw.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        hyper = [f, f, f, f, f, f, vp]          # b1, 1-b1, b2, 1-b2, eps, wd, stream
        lib.repro_fused_adamw_stats.argtypes = [
            vp, i, vp, i, vp, vp, vp, vp, vp, ctypes.c_longlong, i, *hyper]
        lib.repro_fused_adamw.argtypes = [
            vp, i, vp, i, vp, vp, vp, ctypes.c_longlong, i, *hyper]
        lib.repro_fused_adamw_stats.restype = ctypes.c_int
        lib.repro_fused_adamw.restype = ctypes.c_int
    return lib


def adamw_scalars(lr, c1, c2, clip_scale, device) -> torch.Tensor:
    """The kernel's per-step scalars (lr, c1, c2, clip_scale) as one
    4-element f32 tensor on `device`; tensor inputs stay on the device (no
    host synchronisation)."""
    return torch.stack([torch.as_tensor(x, dtype=torch.float32).to(device).reshape(())
                        for x in (lr, c1, c2, clip_scale)])


def _check(kernel, p, g, m, v, scalars):
    check_operands(kernel, p.device, {"p": p, "g": g},
                   {"m": m, "v": v, "scalars": scalars})
    if not p.numel() == g.numel() == m.numel() == v.numel():
        raise ValueError(f"{kernel}: p, g, m, v differ in size: "
                         f"{p.numel()}, {g.numel()}, {m.numel()}, {v.numel()}")
    if scalars.numel() != 4:
        raise ValueError(f"{kernel}: scalars must hold (lr, c1, c2, clip)")


def _hyper(beta1, beta2, eps, weight_decay, device):
    return (beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps, weight_decay,
            torch.cuda.current_stream(device).cuda_stream)


def fused_adamw_stats(p, g, m, v, scalars, *, beta1: float, beta2: float,
                      eps: float, weight_decay: float) -> torch.Tensor:
    """In-place AdamW over one flat buffer; returns Σg² of the RAW gradient
    as a 0-d f32 tensor on the device.  `scalars` is `adamw_scalars(...)`."""
    _check("fused_adamw_stats", p, g, m, v, scalars)
    lib = _lib()
    n = p.numel()
    grid = grid_for(n)
    partials = torch.empty(grid, dtype=torch.float32, device=p.device)
    gsq = torch.empty((), dtype=torch.float32, device=p.device)
    err = lib.repro_fused_adamw_stats(
        p.data_ptr(), int(p.dtype == torch.bfloat16), g.data_ptr(),
        int(g.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), partials.data_ptr(), gsq.data_ptr(), n, grid,
        *_hyper(beta1, beta2, eps, weight_decay, p.device))
    check_launch(lib, err, "fused_adamw_stats")
    fused_adamw_stats.launches += 1
    return gsq


def fused_adamw(p, g, m, v, scalars, *, beta1: float, beta2: float,
                eps: float, weight_decay: float):
    """In-place AdamW on one tensor (no clip: `scalars[3]` is not read);
    returns (p, m, v)."""
    _check("fused_adamw", p, g, m, v, scalars)
    lib = _lib()
    n = p.numel()
    err = lib.repro_fused_adamw(
        p.data_ptr(), int(p.dtype == torch.bfloat16), g.data_ptr(),
        int(g.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(),
        scalars.data_ptr(), n, grid_for(n),
        *_hyper(beta1, beta2, eps, weight_decay, p.device))
    check_launch(lib, err, "fused_adamw")
    fused_adamw.launches += 1
    return p, m, v


fused_adamw_stats.launches = 0
fused_adamw.launches = 0
