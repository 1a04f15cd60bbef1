"""CUDA kernels: fused AdamW (Algorithm 1's optimizer block, DESIGN §9).

* `fused_adamw_stats_buckets` replaces the TPU kernel `fused_adamw_stats`
  of `repro/kernels/fused_adamw.py` over a whole flat layout: AdamW over
  every bucket with the global-norm clip folded in and the pre-clip Σg²
  over all of them as a byproduct, one launch per dtype group of p and g
  (plain version: `ref.adamw_stats_ref` bucket by bucket).
  `fused_adamw_stats` is the same call over one bucket.
* `fused_adamw_buckets` replaces the TPU kernel `fused_adamw` there over
  a whole parameter tree (the tree route, `ops.fused_adamw_tree`): the
  same update on every leaf, of any shape, no clip, no byproduct, one
  launch per dtype group (plain version `ref.adamw_ref` leaf by leaf).
  `fused_adamw` is the same call over one tensor.

All run the kernel of `csrc/fused_adamw.cu` over a bucket table
(`kernels.buckets`); the sources give the design and the bound.  Each
launch is the CUDA implementation of a PyTorch custom op,
`repro_torch::fused_adamw_stats_buckets` or
`repro_torch::fused_adamw_buckets`, whose in-place operands are declared
mutated and whose fake implementation only makes the output: under
`FakeTensorMode` (the dry-run) no table is built, no scalar uploaded and
nothing launched.  The wrappers take CUDA tensors only (`kernels.ops`
dispatches by device) and raise on anything the kernel does not take.
p, m and v are updated IN PLACE — the port's form of the reference step
donating its buffers.  Each launch of a variant adds one to
`fused_adamw_stats.launches` or `fused_adamw.launches` (a fake call
counts the launches it stands for).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, check_operands, load
from repro_torch.kernels.buckets import (
    ROW, TABLES, check_on_card, launches, table_for)

SOURCE = "fused_adamw"
_FLOAT = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)


def _lib():
    lib = load(SOURCE)
    if lib.repro_fused_adamw.argtypes is None:
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.repro_fused_adamw.argtypes = [vp, i, ll, i, i, i, i, vp, vp,
                                          f, f, f, f, f, f, vp]
        lib.repro_sum_partials.argtypes = [vp, i, i, vp, vp]
        lib.repro_fused_adamw.restype = lib.repro_sum_partials.restype = ctypes.c_int
    return lib


def adamw_scalars(lr, c1, c2, clip_scale, device) -> torch.Tensor:
    """The kernel's per-step scalars (lr, c1, c2, clip_scale) as one
    4-element f32 tensor on `device`.  Inputs already on the device stay
    there; the host's (floats, CPU tensors such as the schedule's lr) go
    up together in ONE non-blocking copy from pinned memory, so the host
    never waits on the stream for them (the caching host allocator keeps
    the pinned block until the copy has run)."""
    device = torch.device(device)
    vals = [torch.as_tensor(x, dtype=torch.float32).reshape(())
            for x in (lr, c1, c2, clip_scale)]
    host = [i for i, x in enumerate(vals) if x.device != device]
    if host and device.type == "cuda":
        staged = torch.stack([vals[i].cpu() for i in host]).pin_memory()
        up = staged.to(device, non_blocking=True)
        for j, i in enumerate(host):
            vals[i] = up[j]
    elif host:
        vals = [x.to(device) for x in vals]
    return torch.stack(vals)


def _launch(kernel, pb, gb, mb, vb, scalars, stats: bool, hyper):
    """Launch the kernel once per dtype group of the buckets; return (with
    `stats`, Σg²_raw over all of them as a 0-d f32 tensor, else None; the
    number of launches).  The CUDA
    implementation of the ops below: the bucket table, and the scalars'
    pinned upload when they come as (lr, c1, c2, clip), are made here,
    never for a fake call."""
    if not len(pb) == len(gb) == len(mb) == len(vb):
        raise ValueError(f"{kernel}: {len(pb)} p, {len(gb)} g, {len(mb)} m and "
                         f"{len(vb)} v buffers")
    groups, count, table = table_for(kernel, TABLES, list(zip(pb, gb, mb, vb)),
                                     ("p", "g", "m", "v"), (_FLOAT, _FLOAT, _F32, _F32))
    device = table.device
    scalars = (scalars[0] if len(scalars) == 1
               else adamw_scalars(*scalars, device))
    check_operands(kernel, device, {}, {"scalars": scalars})
    if scalars.numel() != 4:
        raise ValueError(f"{kernel}: scalars must hold (lr, c1, c2, clip)")
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    partials = torch.empty(count if stats else 0, dtype=torch.float32, device=device)
    launched = [grp for grp in groups if grp.tiles]
    for grp in launched:
        err = lib.repro_fused_adamw(
            table.data_ptr() + 8 * ROW * grp.first_row, len(grp.rows), grp.tiles,
            grp.grid, int(grp.dtypes[0] == "bfloat16"), int(grp.dtypes[1] == "bfloat16"),
            int(stats), scalars.data_ptr(),
            partials.data_ptr() + 4 * grp.first_partial if stats else None,
            hyper["beta1"], 1.0 - hyper["beta1"], hyper["beta2"], 1.0 - hyper["beta2"],
            hyper["eps"], hyper["weight_decay"], stream)
        check_launch(lib, err, kernel)
    if not stats:
        return None, len(launched)
    gsq = torch.empty((), dtype=torch.float32, device=device)
    check_launch(lib, lib.repro_sum_partials(partials.data_ptr(), count, 1,
                                             gsq.data_ptr(), stream), kernel)
    return gsq, len(launched)


@torch.library.custom_op("repro_torch::fused_adamw_stats_buckets",
                         mutates_args=("pb", "mb", "vb"), device_types="cuda")
def fused_adamw_stats_op(pb: list[torch.Tensor], gb: list[torch.Tensor],
                         mb: list[torch.Tensor], vb: list[torch.Tensor],
                         scalars: list[torch.Tensor], beta1: float, beta2: float,
                         eps: float, weight_decay: float) -> tuple[torch.Tensor, int]:
    """AdamW in place on every bucket; Σg²_raw as a 0-d f32 tensor, and the
    launches."""
    return _launch("fused_adamw_stats", pb, gb, mb, vb, scalars, True,
                   dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


@fused_adamw_stats_op.register_fake
def _(pb, gb, mb, vb, scalars, beta1, beta2, eps, weight_decay):
    return (pb[0].new_empty((), dtype=torch.float32),
            launches(list(zip(pb, gb, mb, vb))))


@torch.library.custom_op("repro_torch::fused_adamw_buckets",
                         mutates_args=("pb", "mb", "vb"), device_types="cuda")
def fused_adamw_op(pb: list[torch.Tensor], gb: list[torch.Tensor],
                   mb: list[torch.Tensor], vb: list[torch.Tensor],
                   scalars: list[torch.Tensor], beta1: float, beta2: float,
                   eps: float, weight_decay: float) -> int:
    """AdamW in place on every tensor, no clip; the launches."""
    return _launch("fused_adamw", pb, gb, mb, vb, scalars, False,
                   dict(beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay))[1]


@fused_adamw_op.register_fake
def _(pb, gb, mb, vb, scalars, beta1, beta2, eps, weight_decay):
    return launches(list(zip(pb, gb, mb, vb)))


def _call(kernel, counter, op, pb, gb, mb, vb, scalars, hyper):
    """`op` over the buckets, adding its launches (one per dtype group of
    (p, g)) to `counter.launches`; returns its Σg² (None without).
    `scalars` is `adamw_scalars(...)` or the tuple (lr, c1, c2, clip),
    which the op takes to the card."""
    if not pb:
        raise ValueError(f"{kernel}: no buckets")
    check_on_card(kernel, "p", pb[0])
    scalars = ([scalars] if torch.is_tensor(scalars) else
               [torch.as_tensor(x, dtype=torch.float32) for x in scalars])
    out = op(list(pb), list(gb), list(mb), list(vb), scalars, **hyper)
    gsq, n = out if isinstance(out, tuple) else (None, out)
    counter.launches += n
    return gsq


def fused_adamw_stats_buckets(pb, gb, mb, vb, scalars, *, beta1: float,
                              beta2: float, eps: float,
                              weight_decay: float) -> torch.Tensor:
    """In-place AdamW over every bucket (p_i, g_i, m_i, v_i) of the lists;
    returns Σg² of the RAW gradient over all of them as a 0-d f32 tensor on
    the device.  `scalars` is `adamw_scalars(...)` or the tuple (lr, c1,
    c2, clip_scale), floats or tensors, taken to the card inside the op.
    One launch per dtype group of (p, g), plus one that adds the per-block
    partials."""
    return _call("fused_adamw_stats", fused_adamw_stats, fused_adamw_stats_op,
                 pb, gb, mb, vb, scalars,
                 dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


def fused_adamw_stats(p, g, m, v, scalars, *, beta1: float, beta2: float,
                      eps: float, weight_decay: float) -> torch.Tensor:
    """`fused_adamw_stats_buckets` over the one bucket (p, g, m, v)."""
    return fused_adamw_stats_buckets([p], [g], [m], [v], scalars, beta1=beta1,
                                     beta2=beta2, eps=eps, weight_decay=weight_decay)


def fused_adamw_buckets(pb, gb, mb, vb, scalars, *, beta1: float,
                        beta2: float, eps: float, weight_decay: float):
    """In-place AdamW (no clip: `scalars[3]` is not read) over every tensor
    (p_i, g_i, m_i, v_i) of the lists, each of any shape: one launch per
    dtype group of (p, g)."""
    _call("fused_adamw", fused_adamw, fused_adamw_op, pb, gb, mb, vb, scalars,
          dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


def fused_adamw(p, g, m, v, scalars, *, beta1: float, beta2: float,
                eps: float, weight_decay: float):
    """`fused_adamw_buckets` over the one tensor (p, g, m, v); returns
    (p, m, v)."""
    fused_adamw_buckets([p], [g], [m], [v], scalars, beta1=beta1, beta2=beta2,
                        eps=eps, weight_decay=weight_decay)
    return p, m, v


fused_adamw_stats.launches = 0
fused_adamw.launches = 0
