"""CUDA kernel: Σ(x−y)² in f32 in one read of each operand — the norm
test's squared deviation ‖g_j − g‖² on the tree route.

Replaces the TPU kernel `sqdiff_norm` of `repro/kernels/sqdiff_norm.py`.
It is the second variant of `csrc/fused_stats.cu` (the same streaming
loop without Σy²), launched over a bucket table: `sqdiff_norm` over a
table of one row, `sqdiff_norm_buckets` (the tree route,
`ops.sqdiff_norm_tree`) over one row a leaf pair, one launch per dtype
group, as the custom op `repro_torch::sqdiff_norm_buckets` (its fake
implementation, for `FakeTensorMode`, in `fused_stats.py`).  The plain
version is `ref.sqdiff_norm_ref`.

The wrappers take CUDA tensors only (`kernels.ops` dispatches by device)
and raise on anything the kernel does not take.  Each launch adds one to
`sqdiff_norm.launches`.
"""

from __future__ import annotations

from repro_torch.kernels.fused_stats import call_stats, check_same_shape, sqdiff_norm_op


def sqdiff_norm(x, y):
    """Σ(x−y)² as a 0-d f32 tensor on the device; x and y are float32 or
    bfloat16 (each its own) and of the same shape."""
    check_same_shape("sqdiff_norm", x, y)
    return call_stats("sqdiff_norm", sqdiff_norm, sqdiff_norm_op, [x], [y])[0]


def sqdiff_norm_buckets(xs, ys):
    """Σ_i Σ(x_i−y_i)² over every pair of the lists as a 0-d f32 tensor on
    the device: one launch per dtype group, the per-block partials added
    in a fixed order (the same bits on every call)."""
    if len(xs) != len(ys):
        raise ValueError(f"sqdiff_norm: {len(xs)} x and {len(ys)} y tensors")
    for x, y in zip(xs, ys):
        check_same_shape("sqdiff_norm", x, y)
    return call_stats("sqdiff_norm", sqdiff_norm, sqdiff_norm_op, xs, ys)[0]


sqdiff_norm.launches = 0
