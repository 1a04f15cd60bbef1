"""CUDA kernel: the norm test's fused statistics pair (Σ(x−y)², Σy²) in one
read of each operand (DESIGN §9).

Replaces the TPU kernel `fused_stats` of `repro/kernels/fused_stats.py`.
FSDP-Norm calls `fused_stats_buckets` once per step over every flat
bucket, with x_i = g_j (the worker's gradient) and y_i = g (the mean
gradient): ‖g_j − g‖² and ‖g‖² over the whole layout, one launch per dtype
group of (x, y).  `fused_stats` is the same call over one pair.  The
source, with its design and bound, is `csrc/fused_stats.cu` (and the
bucket table's, `csrc/buckets.cuh`); the plain version is
`ref.fused_stats_ref`.

The wrappers take CUDA tensors only (`kernels.ops` dispatches by device)
and raise on anything the kernel does not take.  Each launch adds one to
`fused_stats.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, load
from repro_torch.kernels.buckets import ROW, TABLES, table_for

SOURCE = "fused_stats"       # one source for fused_stats and sqdiff_norm
_FLOAT = (torch.float32, torch.bfloat16)


def stats_lib():
    """The library of `csrc/fused_stats.cu`, its entry points bound."""
    lib = load(SOURCE)
    if lib.repro_fused_stats.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_fused_stats.argtypes = [vp, i, ctypes.c_longlong, i, i, i, i,
                                          vp, i, vp]
        lib.repro_sum_partials.argtypes = [vp, i, i, vp, vp]
        lib.repro_fused_stats.restype = lib.repro_sum_partials.restype = ctypes.c_int
    return lib


def check_same_shape(kernel: str, x, y):
    if x.shape != y.shape:
        raise ValueError(f"{kernel}: x and y differ in shape: "
                         f"{tuple(x.shape)} vs {tuple(y.shape)}")


def launch_stats(kernel: str, counter, xs, ys, outputs: int) -> torch.Tensor:
    """Launch the stats kernel once per dtype group of the pairs (x_i, y_i)
    (`outputs` 2: both sums, 1: Σ(x−y)² alone), add one to
    `counter.launches` for each, and return the `outputs` f32 sums over
    every pair as a 1-D tensor on the device."""
    if len(xs) != len(ys):
        raise ValueError(f"{kernel}: {len(xs)} x and {len(ys)} y buffers")
    groups, count, table = table_for(kernel, TABLES, list(zip(xs, ys)), ("x", "y"),
                                     (_FLOAT, _FLOAT))
    device = table.device
    lib = stats_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    partials = torch.empty(outputs * count, dtype=torch.float32, device=device)
    for grp in groups:
        if not grp.tiles:
            continue
        err = lib.repro_fused_stats(
            table.data_ptr() + 8 * ROW * grp.first_row, len(grp.rows), grp.tiles,
            grp.grid, int(grp.dtypes[0] == "bfloat16"), int(grp.dtypes[1] == "bfloat16"),
            int(outputs == 2), partials.data_ptr() + 4 * grp.first_partial, count, stream)
        check_launch(lib, err, kernel)
        counter.launches += 1
    out = torch.empty(outputs, dtype=torch.float32, device=device)
    check_launch(lib, lib.repro_sum_partials(partials.data_ptr(), count, outputs,
                                             out.data_ptr(), stream), kernel)
    return out


def fused_stats_buckets(xs, ys):
    """(Σ_i Σ(x_i−y_i)², Σ_i Σy_i²) over every pair of the lists, as two 0-d
    f32 tensors on the device; each x_i and y_i is float32 or bfloat16
    (each its own), and the two of a pair have one element count."""
    out = launch_stats("fused_stats", fused_stats, xs, ys, 2)
    return out[0], out[1]


def fused_stats(x, y):
    """`fused_stats_buckets` over the one pair (x, y), of the same shape."""
    check_same_shape("fused_stats", x, y)
    return fused_stats_buckets([x], [y])


fused_stats.launches = 0
