"""CUDA kernel: forward attention with an online softmax on the tensor
cores (split TF32 for f32, bf16 MMA for bf16) — causal (top-left aligned),
sliding window, logit soft-capping, GQA.

Replaces the TPU kernel `flash_attention` of
`repro/kernels/flash_attention.py`, the reference's drop-in for
`models/attention.py::attend_full`.  Prefill runs it once a layer
(`attend_full` under inference mode).  The source, with its design and
bound, is `csrc/flash_attention.cu`; the plain version is
`ref.flash_attention_ref` (`ref.attention_ref` after expanding the kv heads
with `repeat_interleave`).

Unlike the TPU wrapper there is no block-size assert and no padding: any t
and s, tails masked in the kernel.  The wrapper takes CUDA tensors only
(`kernels.ops` dispatches by device), has no backward (it raises under grad
mode on a tensor that requires grad) and raises on anything the kernel
does not take (head dims above 256 among them).  Each
launch adds one to `flash_attention.launches`.

The launch is the CUDA implementation of the PyTorch custom op
`repro_torch::flash_attention`, whose fake implementation (for
`FakeTensorMode`: the dry-run) only makes the output, and whose
operations `torch.utils.flop_counter` counts as 4·d for each (query, key)
pair the causal and window masks admit (`attended_pairs`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import check_launch, check_no_grad, load

SOURCE = "flash_attention"
MAX_HEAD_DIM = 256


def _lib():
    lib = load(SOURCE)
    if lib.repro_flash_attention.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention.argtypes = [
            vp, vp, vp, vp, i, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), f, f, i, i, vp]
        lib.repro_flash_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: {name} must lie on the CUDA "
                             f"device {q.device}, got {x.device}")
        if x.dim() != 4 or x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             f"contiguous last dimension")
        if x.dtype != q.dtype or x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("flash_attention: q, k and v must all be float32 "
                            "or all bfloat16")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} q heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside "
                         f"1..{MAX_HEAD_DIM}")
    if min(b, t, k.shape[1]) < 1 or b * h > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} is outside the kernel's grid")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, softcap: float) -> torch.Tensor:
    """The launch: a new contiguous (b, t, h, d) tensor of q's dtype."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v)
                                        for i in range(3)))
    lib = _lib()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, t, s, h, kvh, d, strides,
        1.0 / math.sqrt(d), float(softcap), int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, err, "flash_attention")
    return out


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap):
    return q.new_empty(q.shape)


def attended_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks admit in one head, as
    `ref.attention_ref` masks them: key j for query i when j <= i (causal,
    top-left aligned) and j > i - window (window > 0)."""
    i = np.arange(t, dtype=np.int64)
    hi = np.minimum(i, s - 1) if causal else np.full(t, s - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(t, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, *args,
                 **kwargs) -> int:
    """4·d operations a (query, key) pair the masks admit, in every head
    of every row: q·k and p·v, a multiply and an add each."""
    b, t, h, d = q_shape
    return 4 * d * b * h * attended_pairs(t, k_shape[1], causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (b, t, h, d); k, v: (b, s, kvh, d), h % kvh == 0, 1 <= d <= 256;
    all float32 or all bfloat16.  Softmax scale 1/sqrt(d).  Returns a
    new contiguous (b, t, h, d) tensor of q's dtype."""
    check_no_grad("flash_attention", q, k, v)
    _check(q, k, v)
    out = flash_attention_op(q, k, v, bool(causal), int(window), float(softcap))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
