"""Flat-buffer sharding over the data-parallel workers (the flat-buffer
helpers of `repro/distributed/sharding.py` and the shard view of
`repro/distributed/train_step.py::_shard_bucket`).

Bucket buffers are padded to a J-divisible size (`FlatLayout.from_tree(...,
shard_divisor=J)`), so worker j's shard of a bucket of n·J elements is the
contiguous slice [j·n, (j+1)·n) — the order the reference's `P(daxes)`
lays shards out in.  Flat parameters REST as the worker's shards; the step
all-gathers them into full buffers before the forward pass.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import num_workers, worker_index


def shard_bucket(b: torch.Tensor, idx: int, J: int) -> torch.Tensor:
    """Worker `idx`'s 1/J slice of one J-divisible bucket, as a view (J = 1:
    the bucket itself)."""
    if J == 1:
        return b
    n = b.shape[0] // J
    return b[idx * n:(idx + 1) * n]


def shard_flat_buffers(buffers):
    """This worker's shard of each bucket, each its own tensor (a copy, so
    that no shard aliases a full buffer it is gathered into); one worker:
    the buffers themselves."""
    J = num_workers()
    if J == 1:
        return list(buffers)
    idx = worker_index()
    return [shard_bucket(b, idx, J).clone() for b in buffers]


def gather_flat_buffers(shards, out=None):
    """All-gather each bucket's shards into the full buffer, one
    `all_gather_into_tensor` per bucket, into `out` when given (fresh
    buffers otherwise).  One worker: the shards are the full buffers."""
    J = num_workers()
    if J == 1:
        return list(shards)
    if out is None:
        out = [s.new_empty(s.numel() * J) for s in shards]
    for full, s in zip(out, shards):
        dist.all_gather_into_tensor(full, s)
    return list(out)
