"""CUDA kernel: row-wise RMSNorm, `x / sqrt(mean(x²) + eps) * scale`.

Replaces the TPU kernel `rmsnorm` of `repro/kernels/rmsnorm.py`.  Serving
(prefill and decode) runs it for every norm of the model: two a layer and
the final one (`models/norms.py::apply_norm` under inference mode).  The
source, with its design and bound, is `csrc/rmsnorm.cu`; the plain version
is `ref.rmsnorm_ref`.

The launch is the CUDA implementation of the PyTorch custom op
`repro_torch::rmsnorm`, whose fake implementation (for `FakeTensorMode`:
the dry-run) only makes the output.  The wrapper takes CUDA tensors only
(`kernels.ops` dispatches by device), has no backward (it raises under
grad mode on a tensor that requires grad) and raises on anything the
kernel does not take.  Each launch adds one to `rmsnorm.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, check_no_grad, check_operands, load

SOURCE = "rmsnorm"


def _lib():
    lib = load(SOURCE)
    if lib.repro_rmsnorm.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_rmsnorm.argtypes = [vp, i, vp, i, vp, ctypes.c_longlong, i,
                                      ctypes.c_float, vp]
        lib.repro_rmsnorm.restype = ctypes.c_int
    return lib


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cuda")
def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The launch: a new tensor of x's shape and dtype."""
    out = torch.empty_like(x)
    d = x.shape[-1]
    lib = _lib()
    err = lib.repro_rmsnorm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
        int(scale.dtype == torch.bfloat16), out.data_ptr(), x.numel() // d, d, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, err, "rmsnorm")
    return out


@rmsnorm_op.register_fake
def _(x, scale, eps):
    return torch.empty_like(x)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d), float32 or bfloat16, contiguous; scale: (d,), float32 or
    bfloat16.  Returns a new tensor of x's shape and dtype."""
    check_no_grad("rmsnorm", x, scale)
    check_operands("rmsnorm", x.device, {"x": x, "scale": scale})
    d = x.shape[-1] if x.dim() else 0
    if d < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale must be ({d},) for x of shape "
                         f"{tuple(x.shape)}, got {tuple(scale.shape)}")
    rows = x.numel() // d
    if rows == 0:
        return torch.empty_like(x)
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows} rows exceed the grid")
    out = rmsnorm_op(x, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
