"""Flat gradient buffers: dtype-homogeneous bucketed views of a parameter
tree (counterpart of `repro/distributed/flatbuf.py`, DESIGN §9/§10).

`FlatLayout` precomputes a static packing of the tree into a few contiguous
buffers so the statistics + AdamW tail runs as one kernel launch per bucket
instead of one per leaf:

* leaves are grouped by **dtype**, first-seen dtype first (a buffer is
  dtype-homogeneous);
* each group is split greedily into **buckets** of ~`bucket_bytes`; a
  bucket closes when the next leaf would overflow it, a single oversized
  leaf is its own bucket, and leaves never straddle buckets;
* every leaf records a static `Slot(leaf_index, buffer_index, offset, size,
  shape)`, in the reference's leaf order (`repro_torch.tree`), so the same
  tree and `bucket_bytes` give the same slots in both packages;
* with `shard_divisor=J` each bucket is zero-padded to a J-divisible size
  (`buffer_pads`); the pad is never referenced by a slot.

Flat residency in the port (DESIGN §10): `unflatten` returns **views** into
the buffers, so parameters that live in bucket buffers are used by the
model through those views, and an in-place update of a buffer is seen by
every view.  The train step writes each leaf's gradient straight into a
congruent view of an f32 gradient buffer, so gradients are born flat too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import TreeDef, tree_flatten, tree_unflatten

# ~4 MiB of f32 per bucket on the card: big enough that per-launch overhead
# is small next to the bucket's traffic, small enough for many buckets
DEFAULT_BUCKET_BYTES = 4 << 20
# CPU: many small buckets keep the plain tail's temporaries cache-sized
CPU_BUCKET_BYTES = 128 << 10


def default_bucket_bytes(device) -> int:
    """Bucket size for buffers that live on `device`."""
    return (DEFAULT_BUCKET_BYTES if torch.device(device).type == "cuda"
            else CPU_BUCKET_BYTES)


def as_torch_dtype(dt) -> torch.dtype:
    """A leaf's dtype as a torch dtype (torch tensors, numpy arrays, and the
    reference's numpy bf16)."""
    if isinstance(dt, torch.dtype):
        return dt
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


@dataclass(frozen=True)
class Slot:
    """Where one leaf lives: `buffer[offset:offset+size].view(shape)`."""
    leaf_index: int          # position in tree_flatten order
    buffer_index: int
    offset: int
    size: int
    shape: tuple


class FlatLayout:
    """Static packing of a tree into dtype-homogeneous bucketed buffers."""

    def __init__(self, treedef: TreeDef, slots, buffer_sizes, buffer_dtypes,
                 buffer_pads=None, shard_divisor: int = 1,
                 bucket_bytes: int | None = None):
        self.treedef = treedef
        self.slots = tuple(slots)                  # ordered by leaf_index
        self.buffer_sizes = tuple(buffer_sizes)    # INCLUDING shard padding
        self.buffer_dtypes = tuple(buffer_dtypes)  # the layout tree's dtypes
        self.buffer_pads = (tuple(buffer_pads) if buffer_pads is not None
                            else (0,) * len(buffer_sizes))
        self.shard_divisor = shard_divisor
        self.bucket_bytes = bucket_bytes
        self.num_buffers = len(buffer_sizes)
        self.num_leaves = len(self.slots)
        self.total_size = sum(buffer_sizes)

    def _cmp_key(self):
        return (self.treedef, self.slots, self.buffer_sizes,
                self.buffer_dtypes, self.buffer_pads, self.shard_divisor)

    def __eq__(self, other):
        return (isinstance(other, FlatLayout)
                and self._cmp_key() == other._cmp_key())

    def __hash__(self):
        return hash(self._cmp_key())

    @classmethod
    def from_tree(cls, tree, bucket_bytes: int | None = None,
                  shard_divisor: int = 1, device=None):
        """Build from torch tensors or numpy arrays (only shapes and dtypes
        are read).  `bucket_bytes` defaults to `default_bucket_bytes` of
        `device` (else of the first torch leaf's device, else the CPU)."""
        leaves, treedef = tree_flatten(tree)
        if bucket_bytes is None:
            if device is None:
                device = next((x.device for x in leaves
                               if isinstance(x, torch.Tensor)), "cpu")
            bucket_bytes = default_bucket_bytes(device)
        if shard_divisor < 1:
            raise ValueError(f"shard_divisor must be >= 1, got {shard_divisor}")
        by_dtype: dict = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(as_torch_dtype(leaf.dtype), []).append(i)

        slots = {}
        sizes, pads, dtypes = [], [], []

        def close(data_size, dt):
            pad = (-data_size) % shard_divisor
            sizes.append(data_size + pad)
            pads.append(pad)
            dtypes.append(dt)

        for dt, idxs in by_dtype.items():
            target = max(1, bucket_bytes // max(dt.itemsize, 1))
            cur_off = 0
            open_bucket = False
            for i in idxs:
                shape = tuple(leaves[i].shape)
                size = math.prod(shape) if shape else 1
                if open_bucket and cur_off and cur_off + size > target:
                    close(cur_off, dt)
                    cur_off = 0
                    open_bucket = False
                if not open_bucket:
                    buf_idx = len(sizes)
                    open_bucket = True
                slots[i] = Slot(i, buf_idx, cur_off, size, shape)
                cur_off += size
            if open_bucket:
                # cur_off may be 0 (a bucket of only size-0 leaves): still
                # a real bucket, or its slots would dangle
                close(cur_off, dt)
        ordered = [slots[i] for i in range(len(leaves))]
        return cls(treedef, ordered, sizes, dtypes, pads, shard_divisor,
                   bucket_bytes)

    # ------------------------------------------------------------ pack ----

    def flatten(self, tree):
        """Pack a congruent tree of tensors into fresh buffers (list of 1-D
        tensors; the dtype is the tree's, the shard pad zero-filled)."""
        leaves, _ = tree_flatten(tree)
        if len(leaves) != self.num_leaves:
            raise ValueError(
                f"tree has {len(leaves)} leaves, layout expects {self.num_leaves}")
        parts: list = [[] for _ in range(self.num_buffers)]
        for slot, leaf in zip(self.slots, leaves):
            if tuple(leaf.shape) != slot.shape:
                raise ValueError(
                    f"leaf {slot.leaf_index} shape {tuple(leaf.shape)} != "
                    f"layout shape {slot.shape}")
            parts[slot.buffer_index].append((slot.offset, leaf))
        buffers = []
        for bi, plist in enumerate(parts):
            plist.sort(key=lambda t: t[0])
            ravels = [leaf.detach().reshape(-1) for _, leaf in plist]
            if len({r.dtype for r in ravels}) != 1:
                raise ValueError(
                    f"buffer {bi} mixes dtypes {sorted({str(r.dtype) for r in ravels})}")
            buf = torch.cat(ravels + [ravels[0].new_zeros(self.buffer_pads[bi])])
            buffers.append(buf)
        return buffers

    # the transpose of `unflatten` is packing: in the port, leaf cotangents
    # of any dtype pack through the same slots as `flatten`
    pack_cotangents = flatten

    def unflatten(self, buffers):
        """The tree of views `buffer[offset:offset+size].view(shape)` — no
        copy; writes through a view land in the buffer and vice versa."""
        if len(buffers) != self.num_buffers:
            raise ValueError(
                f"got {len(buffers)} buffers, layout expects {self.num_buffers}")
        for bi, (buf, size) in enumerate(zip(buffers, self.buffer_sizes)):
            if buf.dim() != 1 or buf.numel() != size:
                raise ValueError(
                    f"buffer {bi} has shape {tuple(buf.shape)}, layout "
                    f"expects ({size},)")
        leaves = [buffers[s.buffer_index][s.offset:s.offset + s.size].view(s.shape)
                  for s in self.slots]
        return tree_unflatten(self.treedef, leaves)

    def zeros(self, dtype=torch.float32, device="cpu"):
        """Fresh zero buffers (gradient and moment state)."""
        return [torch.zeros((n,), dtype=dtype, device=device)
                for n in self.buffer_sizes]


__all__ = ["FlatLayout", "Slot", "default_bucket_bytes", "as_torch_dtype",
           "DEFAULT_BUCKET_BYTES", "CPU_BUCKET_BYTES"]
