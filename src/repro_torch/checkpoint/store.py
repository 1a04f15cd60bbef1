"""Checkpointing: tree <-> npz with step metadata and atomic writes
(counterpart of `repro/checkpoint/store.py`, in the same on-disk format).

Host-based: leaves are copied to host memory, then written.  The tree is
flattened to path-keyed arrays — "/"-joined dict keys and list or tuple
indices, the keys the reference builds from `tree_flatten_with_path` — so
restore does not depend on Python object identity, and a checkpoint
written by either package restores in the other.  A bf16 leaf is written
as the reference writes it (the raw 2-byte bf16 bits, numpy dtype `|V2`)
and restores bit-exactly into a bf16 reader; restoring those bits into any
other dtype is a `CheckpointError`.

Flat-resident interop (DESIGN §10): a flat-resident job saves its raw param
bucket buffers (keys ``params/0..N``) plus the layout RECIPE in metadata
(``flat_params``: bucket_bytes + shard_divisor — `FlatLayout.from_tree` is
deterministic given those and the params structure).  `restore_params` /
`restore_params_flat` read a checkpoint of EITHER residency into the
caller's residency, bit-exactly, even across different bucket sizes: the
reader rebuilds the writer's layout from the metadata, unflattens, and
(for a flat reader) re-flattens at its own layout.

Crash atomicity (DESIGN §12): both files of a checkpoint are written to
temp names and `os.replace`d, json FIRST — `latest_step` keys on the npz,
so the only states a crash at any instant can leave are (a) temp litter a
later save cleans up, (b) a json without its npz (invisible to
`latest_step`), or (c) a complete npz+json pair.  A torn or unreadable
checkpoint surfaces as a typed `CheckpointError` naming the file, never a
partial silent restore.  One writer per directory is assumed: under
several workers, rank 0 writes (`launch/train.py`).

Restored leaves are CPU tensors (the reference returns host arrays too);
the caller moves them to its device.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from repro_torch.distributed.flatbuf import as_torch_dtype
from repro_torch.testing.faults import fault_point
from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

# how the reference's npz holds a bf16 array: its raw 2-byte bits
_BF16_NPZ = np.dtype("V2")


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, torn, or inconsistent with the reader's
    expected structure — restore refuses to proceed partially."""


def _host_array(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_NPZ)
    return t.numpy()


def _flatten_with_paths(tree) -> dict:
    return {key: _host_array(leaf) for key, leaf in tree_paths(tree)}


def _clean_stale_tmp(directory: str) -> None:
    """Drop temp litter a crashed writer left behind (single-writer dirs)."""
    for f in os.listdir(directory):
        if f.startswith("ckpt_") and ".tmp" in f:
            with contextlib.suppress(OSError):
                os.remove(os.path.join(directory, f))


def save_checkpoint(directory: str, step: int, tree, metadata: dict | None = None):
    os.makedirs(directory, exist_ok=True)
    _clean_stale_tmp(directory)
    flat = _flatten_with_paths(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    meta_path = os.path.join(directory, f"ckpt_{step:08d}.json")
    tmp_npz = f"{path}.tmp{os.getpid()}"
    tmp_json = f"{meta_path}.tmp{os.getpid()}"
    with open(tmp_npz, "wb") as f:       # a file OBJECT: savez appends no suffix
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    meta = {"step": step, **(metadata or {})}
    with open(tmp_json, "w") as f:
        json.dump(meta, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())
    fault_point("ckpt.save.before_commit", path=path)
    # json first: the npz's visibility implies its metadata already exists,
    # so `latest_step` (npz-keyed) only ever names complete pairs
    os.replace(tmp_json, meta_path)
    os.replace(tmp_npz, path)
    fault_point("ckpt.saved", path=path)
    return path


def latest_step(directory: str) -> int | None:
    """The newest step with a COMPLETE npz+json pair (a crash mid-save can
    leave temp litter or a lone json; neither is restorable)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")
             and ".tmp" not in f
             and os.path.exists(os.path.join(directory, f[:-4] + ".json"))]
    return max(steps) if steps else None


def _open_npz(path: str):
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint {path} does not exist")
    try:
        return np.load(path)
    except Exception as e:   # zipfile.BadZipFile, OSError, ValueError...
        raise CheckpointError(
            f"checkpoint {path} is unreadable (truncated or corrupt): "
            f"{e}") from e


def _get_array(data, key: str, path: str):
    try:
        return data[key]
    except KeyError:
        raise CheckpointError(
            f"checkpoint {path} has no entry {key!r} — it was saved from a "
            "different state structure than the reader's") from None
    except Exception as e:   # torn member: zlib/zipfile error mid-extract
        raise CheckpointError(
            f"checkpoint {path} entry {key!r} is torn or corrupt: {e}") from e


def _tensor_dtype(arr: np.ndarray):
    """The tensor dtype a checkpoint array holds (None when it has none)."""
    if arr.dtype == _BF16_NPZ:
        return torch.bfloat16
    return as_torch_dtype(arr.dtype) if arr.dtype.kind in "biuf" else None


def _as_tensor(arr: np.ndarray, dtype: torch.dtype, key: str, path: str):
    """A CPU tensor of `dtype` from a checkpoint array: a cast, as the
    reference's `astype`, except for bf16 bits, which restore only as
    bf16 (bit-exact)."""
    held = _tensor_dtype(arr)
    if held is None:
        raise CheckpointError(
            f"checkpoint {path} entry {key!r} has npz dtype {arr.dtype}, "
            "which has no tensor dtype")
    if held == torch.bfloat16:
        if dtype != torch.bfloat16:
            raise CheckpointError(
                f"checkpoint {path} entry {key!r} holds bfloat16 bits "
                f"(npz dtype {arr.dtype}); the reader expects {dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dtype)


def restore_checkpoint(directory: str, step: int, like_tree):
    """Restore into the structure of `like_tree` (torch tensors on any
    device, `meta` included, or numpy arrays; only shapes and dtypes are
    read): CPU tensors of the like leaves' dtypes.  Any torn file, missing
    entry or shape mismatch is a `CheckpointError`, never a partial
    restore.  Returns (tree, metadata)."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    data = _open_npz(path)
    leaves = []
    for key, like in tree_paths(like_tree):
        arr = _get_array(data, key, path)
        if tuple(arr.shape) != tuple(like.shape):
            raise CheckpointError(
                f"checkpoint {path} entry {key!r} has shape {arr.shape}, "
                f"reader expects {tuple(like.shape)}")
        leaves.append(_as_tensor(arr, as_torch_dtype(like.dtype), key, path))
    return (tree_unflatten(tree_flatten(like_tree)[1], leaves),
            _read_meta(directory, step))


# ------------------------------------------- flat-resident interop ----

FLAT_PARAMS_META = "flat_params"


def flat_params_metadata(layout) -> dict:
    """The layout recipe a reader needs to rebuild the EXACT `FlatLayout`
    of a flat-resident params checkpoint: `FlatLayout.from_tree` is
    deterministic given the params structure plus these two knobs."""
    return {"bucket_bytes": layout.bucket_bytes,
            "shard_divisor": layout.shard_divisor}


def _read_meta(directory: str, step: int) -> dict:
    meta_path = os.path.join(directory, f"ckpt_{step:08d}.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore_params(directory: str, step: int, params_like):
    """The checkpoint's ``params`` entry as a tree shaped like
    `params_like`, whatever residency it was saved in (bit-exact).

    Tree-resident checkpoints restore leaf by leaf (cast to the reader's
    dtypes, like `restore_checkpoint`); flat-resident ones (metadata
    carries ``flat_params``) rebuild the writer's layout from
    `params_like` and unflatten the raw bucket buffers — there the reader's
    dtypes must MATCH the checkpoint's (buffers are dtype-grouped, so a
    cross-dtype flat restore has no well-defined layout).  Returns (tree,
    metadata)."""
    metadata = _read_meta(directory, step)
    fl = metadata.get(FLAT_PARAMS_META)
    if fl:
        from repro_torch.distributed.flatbuf import FlatLayout
        path = os.path.join(directory, f"ckpt_{step:08d}.npz")
        data = _open_npz(path)
        layout = FlatLayout.from_tree(
            params_like, bucket_bytes=int(fl["bucket_bytes"]),
            shard_divisor=int(fl["shard_divisor"]))
        buffers = []
        for i, (size, dt) in enumerate(zip(layout.buffer_sizes,
                                           layout.buffer_dtypes)):
            key = f"params/{i}"
            arr = _get_array(data, key, path)
            if arr.shape != (size,):
                raise CheckpointError(
                    f"checkpoint {path} params buffer {i} has shape "
                    f"{arr.shape}, writer's layout says ({size},)")
            if _tensor_dtype(arr) != dt:
                raise CheckpointError(
                    f"buffer {i}: checkpoint dtype {arr.dtype} != reader's "
                    f"layout dtype {dt} — flat-resident restore requires "
                    f"matching param dtypes")
            buffers.append(_as_tensor(arr, dt, key, path))
        return layout.unflatten(buffers), metadata
    # tree-resident: the standard leaf-keyed restore on the params subtree
    tree, metadata = restore_checkpoint(directory, step,
                                        {"params": params_like})
    return tree["params"], metadata


def restore_params_flat(directory: str, step: int, params_like, *,
                        bucket_bytes: int | None = None,
                        shard_divisor: int = 1):
    """`FlatParams` at the CALLER's layout (its bucket size / its worker
    count) from a checkpoint of either residency — the unflatten-via-
    writer-layout → flatten-via-reader-layout round trip is bit-exact.
    Returns (FlatParams, metadata)."""
    from repro_torch.distributed.flatbuf import FlatParams
    tree, metadata = restore_params(directory, step, params_like)
    return (FlatParams.from_tree(tree, bucket_bytes=bucket_bytes,
                                 shard_divisor=shard_divisor), metadata)
