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
"""

from __future__ import annotations

import ctypes
import math

import torch

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (b, t, h, d); k, v: (b, s, kvh, d), h % kvh == 0, 1 <= d <= 256;
    all float32 or all bfloat16.  Softmax scale 1/sqrt(d).  Returns a
    new contiguous (b, t, h, d) tensor of q's dtype."""
    check_no_grad("flash_attention", q, k, v)
    _check(q, k, v)
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
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
