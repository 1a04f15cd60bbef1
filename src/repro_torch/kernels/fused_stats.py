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

Each launch is the CUDA implementation of a PyTorch custom op,
`repro_torch::fused_stats_buckets` (and `repro_torch::sqdiff_norm_buckets`
for `sqdiff_norm`), whose fake implementation only makes the output: under
`FakeTensorMode` (the dry-run, `launch/dryrun.py`) the dispatcher runs
that instead, and no table is built and nothing launched.  The wrappers
take CUDA tensors only (`kernels.ops` dispatches by device) and raise on
anything the kernel does not take.  Each launch adds one to
`fused_stats.launches` (a fake call counts the launches it stands for).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, load
from repro_torch.kernels.buckets import (
    ROW, TABLES, check_on_card, launches, table_for)

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


def launch_stats(kernel: str, xs, ys, outputs: int):
    """Launch the stats kernel once per dtype group of the pairs (x_i, y_i)
    (`outputs` 2: both sums, 1: Σ(x−y)² alone); return the `outputs` f32
    sums over every pair as a 1-D tensor on the device and the number of
    launches: the CUDA implementation of the ops below (the table is built
    here, never for a fake call)."""
    groups, count, table = table_for(kernel, TABLES, list(zip(xs, ys)), ("x", "y"),
                                     (_FLOAT, _FLOAT))
    device = table.device
    lib = stats_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    partials = torch.empty(outputs * count, dtype=torch.float32, device=device)
    launched = [grp for grp in groups if grp.tiles]
    for grp in launched:
        err = lib.repro_fused_stats(
            table.data_ptr() + 8 * ROW * grp.first_row, len(grp.rows), grp.tiles,
            grp.grid, int(grp.dtypes[0] == "bfloat16"), int(grp.dtypes[1] == "bfloat16"),
            int(outputs == 2), partials.data_ptr() + 4 * grp.first_partial, count, stream)
        check_launch(lib, err, kernel)
    out = torch.empty(outputs, dtype=torch.float32, device=device)
    check_launch(lib, lib.repro_sum_partials(partials.data_ptr(), count, outputs,
                                             out.data_ptr(), stream), kernel)
    return out, len(launched)


@torch.library.custom_op("repro_torch::fused_stats_buckets", mutates_args=(),
                         device_types="cuda")
def fused_stats_op(xs: list[torch.Tensor],
                   ys: list[torch.Tensor]) -> tuple[torch.Tensor, int]:
    """(Σ(x−y)², Σy²) over every pair, as a (2,) f32 tensor; launches."""
    return launch_stats("fused_stats", xs, ys, 2)


@torch.library.custom_op("repro_torch::sqdiff_norm_buckets", mutates_args=(),
                         device_types="cuda")
def sqdiff_norm_op(xs: list[torch.Tensor],
                   ys: list[torch.Tensor]) -> tuple[torch.Tensor, int]:
    """Σ(x−y)² over every pair, as a (1,) f32 tensor; launches."""
    return launch_stats("sqdiff_norm", xs, ys, 1)


def _fake(outputs: int):
    def fake(xs, ys):
        return (xs[0].new_empty(outputs, dtype=torch.float32),
                launches(list(zip(xs, ys))))
    return fake


fused_stats_op.register_fake(_fake(2))
sqdiff_norm_op.register_fake(_fake(1))


def call_stats(kernel: str, counter, op, xs, ys) -> torch.Tensor:
    """`op` over the pairs (x_i, y_i), adding to `counter.launches` the
    launches it made (one per dtype group)."""
    if len(xs) != len(ys):
        raise ValueError(f"{kernel}: {len(xs)} x and {len(ys)} y buffers")
    if not xs:
        raise ValueError(f"{kernel}: no buckets")
    check_on_card(kernel, "x", xs[0])
    out, n = op(list(xs), list(ys))
    counter.launches += n
    return out


def fused_stats_buckets(xs, ys):
    """(Σ_i Σ(x_i−y_i)², Σ_i Σy_i²) over every pair of the lists, as two 0-d
    f32 tensors on the device; each x_i and y_i is float32 or bfloat16
    (each its own), and the two of a pair have one element count."""
    out = call_stats("fused_stats", fused_stats, fused_stats_op, xs, ys)
    return out[0], out[1]


def fused_stats(x, y):
    """`fused_stats_buckets` over the one pair (x, y), of the same shape."""
    check_same_shape("fused_stats", x, y)
    return fused_stats_buckets([x], [y])


fused_stats.launches = 0
