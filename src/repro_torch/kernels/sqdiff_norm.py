"""CUDA kernel: Σ(x−y)² in f32 in one read of each operand — the norm
test's squared deviation ‖g_j − g‖² on the tree route.

Replaces the TPU kernel `sqdiff_norm` of `repro/kernels/sqdiff_norm.py`.
It is the second variant of `csrc/fused_stats.cu` (the same streaming
loop without Σy²), launched over a table of one row; the plain version is
`ref.sqdiff_norm_ref`.

The wrapper takes CUDA tensors only (`kernels.ops` dispatches by device)
and raises on anything the kernel does not take.  Each call adds one to
`sqdiff_norm.launches`.
"""

from __future__ import annotations

from repro_torch.kernels.fused_stats import check_same_shape, launch_stats


def sqdiff_norm(x, y):
    """Σ(x−y)² as a 0-d f32 tensor on the device; x and y are float32 or
    bfloat16 (each its own) and of the same shape."""
    check_same_shape("sqdiff_norm", x, y)
    return launch_stats("sqdiff_norm", sqdiff_norm, [x], [y], 1)[0]


sqdiff_norm.launches = 0
