"""The bucket table of the multi-bucket launches (`csrc/buckets.cuh`).

`fused_adamw_stats` and `fused_stats` each run over every flat bucket of a
step in one launch per operand dtype group.  The launch reads a table with
one row per bucket: its operands' addresses, its element count, its first
tile (a prefix sum of ceil(n / TILE) within the group) and whether every
operand allows the kernel's vector access.  `plan` builds that table from
plain integers, with no torch call and no card, so the CPU tests check it.

The table reaches the card once: `TableCache` keeps the device copy keyed
by the operands' (address, dtype) and the element counts.  The step's
buffers are persistent, so every step after the first finds its table
there and a launch needs no host-to-device copy and no synchronisation.
A miss stages the table in pinned memory and copies it without blocking
the host; the tree routes hit whenever the allocator hands back the same
leaf addresses.  The table is built inside the kernels' custom ops, so a
fake call (`FakeTensorMode`) never reads an address; `launches` counts
the launches of a call from its operands' dtypes and sizes alone.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

TILE = 4096            # elements a block takes at a time (kTile in buckets.cuh)
GRID = 132 * 8         # blocks of a launch at most: 8 per SM of an H100.  A
                       # constant, never read from the device: with the
                       # table it fixes the order of every sum
VEC = 4                # elements of one vector access (kVec in common.cuh)
OPERANDS = 4           # operand addresses a row holds
ROW = OPERANDS + 4     # int64 words a row: addresses, n, first tile, aligned, 0


@dataclass(frozen=True)
class Group:
    """The buckets of one launch: those whose operands share one dtype
    tuple, in the caller's order."""
    dtypes: tuple          # each operand's dtype name, e.g. ("float32", "float32")
    rows: tuple            # the table rows (ROW ints each)
    tiles: int             # tiles of the launch
    grid: int              # blocks of the launch: min(GRID, tiles)
    first_row: int         # the group's first row in the whole table
    first_partial: int     # its first slot among the call's per-block partials


def plan(entries) -> tuple[list, int]:
    """The table of one call.  `entries` holds, for each bucket, `(n,
    operands)` with one `(address, itemsize, dtype name)` per operand (at
    most OPERANDS).  Returns the groups, first-seen dtype tuple first, and
    the call's number of per-block partials (the groups' grids summed)."""
    by_dtypes: dict = {}
    for i, (n, operands) in enumerate(entries):
        if not 0 < len(operands) <= OPERANDS:
            raise ValueError(f"bucket {i}: {len(operands)} operands, expected "
                             f"1 to {OPERANDS}")
        by_dtypes.setdefault(tuple(dt for _, _, dt in operands), []).append(i)
    groups, first_row, first_partial = [], 0, 0
    for dtypes, index in by_dtypes.items():
        rows, tiles = [], 0
        for i in index:
            n, operands = entries[i]
            addrs = [a for a, _, _ in operands]
            aligned = all(a % (VEC * size) == 0 for a, size, _ in operands)
            rows.append((*addrs, *[0] * (OPERANDS - len(addrs)), n, tiles,
                         int(aligned), 0))
            tiles += -(-n // TILE)
        grid = min(GRID, tiles)
        groups.append(Group(dtypes, tuple(rows), tiles, grid, first_row,
                            first_partial))
        first_row += len(rows)
        first_partial += grid
    return groups, first_partial


class TableCache:
    """Device tables by key; the least recently used goes past `capacity`
    (room for a layout's one-bucket calls as well as its list calls).
    `builds` and `hits` count the lookups that copied a table to the card
    and those that found it there."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._tables: OrderedDict = OrderedDict()
        self.builds = 0
        self.hits = 0

    def get(self, key, entries, device):
        """(groups, partials, device table) for `key`, planned from
        `entries` and copied to `device` on a miss."""
        found = self._tables.get(key)
        if found is not None:
            self._tables.move_to_end(key)
            self.hits += 1
            return found[:3]
        groups, partials = plan(entries)
        flat = [x for g in groups for row in g.rows for x in row]
        staged = torch.tensor(flat, dtype=torch.int64)
        if torch.device(device).type == "cuda":
            # a non-blocking copy from pinned memory: the host goes on
            # while the table travels, and the entry keeps the staging
            # tensor, so the copy never reads freed memory
            staged = staged.pin_memory()
        table = staged.to(device, non_blocking=True)
        found = self._tables[key] = (groups, partials, table, staged)
        self.builds += 1
        if len(self._tables) > self.capacity:
            self._tables.popitem(last=False)
        return found[:3]


def table_for(kernel: str, cache: TableCache, buckets, names, allowed):
    """Check the operands of every bucket and return `cache.get(...)`.

    `buckets` holds one tuple of tensors a bucket, each named by `names`
    and of a dtype in the matching entry of `allowed`; every tensor must
    be contiguous and lie on the first one's CUDA device, and the
    operands of a bucket must have one element count."""
    if not buckets:
        raise ValueError(f"{kernel}: no buckets")
    device = buckets[0][0].device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: {names[0]} must lie on a CUDA device, "
                         f"got {device}")
    key, entries = [device], []
    for i, operands in enumerate(buckets):
        n = operands[0].numel()
        described = []
        for name, t, ok in zip(names, operands, allowed):
            if t.device != device:
                raise ValueError(f"{kernel}: {name} of bucket {i} must lie on "
                                 f"the CUDA device {device}, got {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: {name} of bucket {i} must be "
                                 f"contiguous")
            if t.dtype not in ok:
                raise TypeError(f"{kernel}: {name} of bucket {i} must be "
                                f"{' or '.join(str(d)[6:] for d in ok)}, "
                                f"got {t.dtype}")
            if t.numel() != n:
                raise ValueError(f"{kernel}: the operands of bucket {i} differ "
                                 f"in size: {[x.numel() for x in operands]}")
            described.append((t.data_ptr(), t.element_size(), str(t.dtype)[6:]))
            key += described[-1][::2]
        key.append(n)
        entries.append((n, described))
    return cache.get(tuple(key), entries, device)


def launches(buckets) -> int:
    """Launches a call over `buckets` (one tuple of tensors a bucket) makes:
    one per dtype group that holds an element, as `plan` groups them.
    Reads dtypes and sizes only, so it counts a fake call like a real one."""
    return len({tuple(t.dtype for t in operands) for operands in buckets
                if operands[0].numel()})


def check_on_card(kernel: str, name: str, t):
    """Raise unless `t` lies on a CUDA device (before an op that has no
    other implementation is called)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must lie on a CUDA device, got "
                         f"{t.device}")


# the device tables of every multi-bucket launch in this process (a table
# depends only on its operands, so the kernels share one cache)
TABLES = TableCache()
