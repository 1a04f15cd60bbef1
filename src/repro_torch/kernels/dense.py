"""CUDA kernel: an f32 matrix product on the tensor cores in split TF32,
`C = A·B`, and the autograd function that runs a dense projection's
forward and both gradients on it.

It replaces no TPU kernel: the reference leaves its einsums against the
weights to XLA.  In the f32 training step those products (q, k, v and the
output projection, the MLP's gate, up and down, the head) took three
quarters of the card's time on the CUDA cores; three TF32 products on the
tensor cores give the same f32 accuracy at up to 2.5 times the rate.  The
source, with its design, precision and bound, is `csrc/dense.cu`.

The launch is the CUDA implementation of the PyTorch custom op
`repro_torch::dense`, whose fake implementation (for `FakeTensorMode`: the
dry-run) only makes the output and whose operations
`torch.utils.flop_counter` counts as 2·M·N·K.  `dense_mm` takes CUDA
tensors only and adds one to `dense_mm.launches` a launch.  `Dense`, the
autograd function, saves its input and the weight view, as the einsum
does: dX = dY·Wᵀ and dW = Xᵀ·dY are launches of the same kernel, reading
the saved tensors in place (each operand K-major or M/N-major, transposed
in shared memory).  The model reaches it only through `ops.dense`, which
routes every call off the card to the einsum itself.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import check_launch, load

SOURCE = "dense"
MIN_ROWS = 64          # one wgmma row tile: fewer rows (decode) keep the einsum


def _lib():
    lib = load(SOURCE)
    if lib.repro_dense.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_dense.argtypes = [vp, vp, vp, i, i, i, ll, ll, ll, ll, vp]
        lib.repro_dense.restype = ctypes.c_int
    return lib


@torch.library.custom_op("repro_torch::dense", mutates_args=(), device_types="cuda")
def dense_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The launch: a new contiguous (M, N) f32 tensor."""
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _lib()
    err = lib.repro_dense(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                          a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                          torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(lib, err, "dense")
    return out


@dense_op.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


@register_flop_formula(torch.ops.repro_torch.dense)
def _dense_flops(a_shape, b_shape, *args, **kwargs) -> int:
    """A multiply and an add for each (m, n, k)."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _unit_stride(x):
    """x itself when one of its two strides is 1, else a contiguous copy."""
    return x if x.stride(1) == 1 or x.stride(0) == 1 else x.contiguous()


def dense_mm(a, b):
    """A (M, K) · B (K, N), both float32 on one CUDA device, any strides
    (a matrix with neither stride 1 is copied first).  Returns a new
    contiguous (M, N) float32 tensor."""
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda" or x.device != a.device:
            raise ValueError(f"dense: {name} must lie on the CUDA device "
                             f"{a.device}, got {x.device}")
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError(f"dense: {name} must be a 2-D float32 matrix, got "
                            f"{x.dtype} {tuple(x.shape)}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"dense: a {tuple(a.shape)} and b {tuple(b.shape)} do "
                         f"not chain")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"dense: shape ({m}, {k}) x ({k}, {n}) exceeds the grid")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    out = dense_op(_unit_stride(a), _unit_stride(b))
    dense_mm.launches += 1
    return out


dense_mm.launches = 0


class Dense(torch.autograd.Function):
    """y = x·w for x (M, K) and a weight view w (K, N): N-major (a weight
    stored (K, ...)) or K-major (the head's (v, d) table, transposed)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dense_mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dense_mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            # in w's own layout: (K, N) for an N-major weight, the transpose
            # of a contiguous (N, K) for a K-major one
            dw = dense_mm(x.t(), g) if w.stride(1) == 1 else dense_mm(g.t(), x).t()
        return dx, dw
