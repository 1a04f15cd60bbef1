"""Workers and the device mesh on `torch.distributed` (counterpart of
`repro/launch/mesh.py`).

The reference lays its devices out as a mesh with named axes — the data
axes ("pod", "data": the norm test's J workers) and "model" (tensor
parallelism).  Here every mesh position is one process, one rank of the
default process group, in row-major order over (pod, data, model), as
`jax.make_mesh` orders devices: rank r has model coordinate r % M.

* `Mesh` — `axis_names`, `shape` (a dict, as `jax.sharding.Mesh.shape`
  is), and, when built inside a process group, this rank's coordinates
  and two groups: its data line (the ranks that share its model
  coordinate) and its model line (the ranks that share its data
  coordinates).  A mesh built outside a group of its size only describes
  a layout (`param_pspecs` reads nothing else);
* `make_host_mesh`, `make_production_mesh`, `data_axes`;
* `num_workers`, `worker_index` — J and j over the data axes of a mesh;
  with no mesh, the default group's size and this rank (one worker a
  rank), 1 and 0 outside a process group; `data_peer` — the global rank
  of data index j in this rank's data group;
* `psum`, `pmean` — the reference's reductions, over a group (default:
  every rank); `host_max` of a host number;
* `init_workers` — join the group as one rank (the caller names the
  backend: "nccl" needs a card per rank, "gloo" lets ranks share a card or
  run on the CPU; nothing switches silently); `init_fake_workers` — join
  a fake group of any size in one process (the dry-run);
* `spawn_workers` — run a function on n new local processes, one rank
  each, and return rank 0's result.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing import resource_tracker
from multiprocessing.connection import wait
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.tracing import span


DATA_AXES = ("pod", "data")
MODEL = "model"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Named axes over ranks.  `coords` (axis -> index) and the groups
    exist only for a mesh built inside a process group of its size;
    `data_group` / `model_group` are None where the line is every rank
    (the default group) and `SELF` where it is this rank alone."""

    def __init__(self, shape, axis_names, *, coords=None, data_group=None,
                 model_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.coords = coords
        self.data_group, self.model_group = data_group, model_group

    def __repr__(self):
        return f"Mesh({self.shape})"

    @property
    def model_size(self) -> int:
        return self.shape.get(MODEL, 1)

    @property
    def model_index(self) -> int:
        return self.coords.get(MODEL, 0) if self.coords else 0

    def axes_index(self, axes) -> int:
        """This rank's flattened index along `axes` (first axis major), the
        order a spec lays shards out in."""
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_for(self, axes):
        """The group of the ranks that differ only along `axes`: the data
        axes (all of them) or "model"."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == (MODEL,):
            return self.model_group
        if axes == data_axes(self):
            return self.data_group
        raise ValueError(f"no group for axes {axes} of {self!r}")


# the group of a line that is this rank alone: collectives over it are
# the identity
SELF = "self"


def _line_groups(shape: dict):
    """Every rank calls `new_group` for every line in the same order (the
    call is collective); keeps its own data line and model line."""
    names = tuple(shape)
    dims = [shape[a] for a in names]
    rank, world = dist.get_rank(), dist.get_world_size()
    coords_of = lambda r: dict(zip(names, np.unravel_index(r, dims)))
    mine = coords_of(rank)

    def lines(axis_set):
        key = lambda r: tuple(c for a, c in coords_of(r).items()
                              if a not in axis_set)
        out = {}
        for r in range(world):
            out.setdefault(key(r), []).append(r)
        return out, key(rank)

    groups = []
    for axis_set in (set(DATA_AXES), {MODEL}):
        members, my_key = lines(axis_set)
        chosen = None
        for k in sorted(members):
            ranks = members[k]
            if len(ranks) == world:
                g = None                         # the default group
            elif len(ranks) == 1:
                g = SELF
            else:
                g = dist.new_group(ranks)
            if k == my_key:
                chosen = g
        groups.append(chosen)
    return {a: int(c) for a, c in mine.items()}, groups


def _make_mesh(shape, axis_names) -> Mesh:
    size = math.prod(shape)
    if _grouped():
        world = dist.get_world_size()
        if world != size:
            raise ValueError(f"a mesh of {dict(zip(axis_names, shape))} needs "
                             f"{size} ranks, the process group has {world}")
        coords, (dg, mg) = _line_groups(dict(zip(axis_names, shape)))
        return Mesh(shape, axis_names, coords=coords, data_group=dg,
                    model_group=mg)
    if size == 1:
        return Mesh(shape, axis_names, coords={a: 0 for a in axis_names},
                    data_group=SELF, model_group=SELF)
    return Mesh(shape, axis_names)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """The (data, model) or (pod, data, model) mesh over this process
    group's ranks (a description only outside a group of its size)."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"))
    return _make_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layouts, (16, 16) or (2, 16, 16): inside
    a process group of 256 or 512 ranks (the dry-run's fake group,
    `init_fake_workers`) this rank's coordinates and line groups, else a
    description with no ranks and no groups."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _grouped() and dist.get_world_size() == math.prod(shape):
        return _make_mesh(shape, axes)
    return Mesh(shape, axes)


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel (norm-test worker) axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def num_workers(mesh=None) -> int:
    """J: the product of the mesh's data axes; with no mesh, the process
    group's size (1 outside a group)."""
    if mesh is not None:
        return math.prod(mesh.shape[a] for a in data_axes(mesh))
    return dist.get_world_size() if _grouped() else 1


def worker_index(mesh=None) -> int:
    """j ∈ [0, J): this rank's index over the mesh's data axes (first axis
    major); with no mesh, its rank (0 outside a group)."""
    if mesh is not None:
        return mesh.axes_index(data_axes(mesh))
    return dist.get_rank() if _grouped() else 0


def data_peer(mesh, j: int) -> int:
    """The global rank at data index `j` (over the data axes, first axis
    major) that shares this rank's other coordinates: rank `j` of this
    rank's data group."""
    daxes = data_axes(mesh)
    coords = dict(mesh.coords)
    for a, c in zip(daxes, np.unravel_index(j, [mesh.shape[a] for a in daxes])):
        coords[a] = int(c)
    return int(np.ravel_multi_index([coords[a] for a in mesh.axis_names],
                                    [mesh.shape[a] for a in mesh.axis_names]))


def group_size(group=None) -> int:
    """Ranks in `group` (None: every rank of the default group)."""
    if group is SELF:
        return 1
    if group is None:
        return num_workers()
    return dist.get_world_size(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of `x` over the group's ranks, IN PLACE; one rank: `x` itself."""
    n = group_size(group)
    if n > 1:
        with span("comm.all_reduce", bytes=x.nbytes, group=n):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def host_max(x: float, group=None) -> float:
    """The largest of the ranks' host numbers (each rank's `x`): one
    all-reduce of a host tensor; outside a group `x` itself."""
    if group_size(group) == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of `x` over the group's ranks, as a new tensor."""
    return psum(x.clone(), group) / group_size(group)


def default_backend(device) -> str:
    """The backend for ranks on `device` when the caller names none: NCCL
    for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """Rank r's device: cuda:(r % device count) on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_workers(backend: str, rank: int, world: int, init_method: str):
    """Join the default process group as `rank` of `world`.  NCCL allows
    one rank per card, so it raises when there are more ranks than cards;
    gloo lets ranks share a card (its collectives of CUDA tensors pass
    through host memory)."""
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"backend 'nccl' needs a card per rank: {world} "
                             f"ranks, {cards} cards; name backend 'gloo' to "
                             f"let ranks share a card")
        torch.cuda.set_device(rank % cards)
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def _register_fake_backend():
    """Make the "fake" backend known to `init_process_group` (once): a
    group that hands every collective its own output and moves nothing,
    torch's `FakeProcessGroup`."""
    if "FAKE" in dist.Backend._plugins:
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        if hasattr(FakeProcessGroup, "_create_internal"):
            return FakeProcessGroup._create_internal(
                common_opts.group_rank, common_opts.group_size, backend_opts)
        return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)

    dist.Backend.register_backend(dist.Backend.FAKE, create, extended_api=True,
                                  devices=["cpu", "cuda"])


def init_fake_workers(world: int, rank: int = 0):
    """Join a fake process group of `world` ranks as `rank`, in this one
    process (the dry-run's: one rank's step traced on the production
    meshes).  Its collectives move nothing, so a step run under
    `FakeTensorMode` goes through them as a real rank's would; groups and
    the meshes built on it are real.  `dist.destroy_process_group()`
    leaves it."""
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(fn, args, rank, world, backend, rundir, threads):
    # spawned ranks share one host: gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(threads)
    try:
        init_workers(backend, rank, world, f"file://{rundir}/rendezvous")
        out = fn(*args)
        if rank == 0:
            torch.save(_to_cpu(out), Path(rundir, "result.pt"))
        # no rank closes its sockets before every rank is through the
        # group's connection handshake: a rank whose `fn` returns at once
        # can otherwise exit while a slower peer is still connecting, and
        # fail that peer's init ("Connection closed by peer")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(rundir, f"error{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn_workers(fn, world: int, *args, backend: str = "gloo",
                  timeout_s: float | None = None):
    """Run `fn(*args)` on `world` new processes (start method "spawn": CUDA
    cannot fork), rank r of one process group each, and return rank 0's
    result with its tensors on the CPU.  The ranks meet through a file in a
    fresh temporary directory (no port, so concurrent runs never collide)
    and share the host's CPU threads.  If a rank fails, the others are
    stopped and its traceback is raised; past `timeout_s` seconds every
    rank is stopped and TimeoutError raised.  Every process it starts has
    ended when it returns, the ranks and the resource tracker that the
    spawn start method starts beside them (unless one ran before the call):
    the tracker outlives an exiting parent otherwise."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._fd is None
    rundir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    ctx = mp.get_context("spawn")
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world, backend, rundir, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        running = list(procs)
        while running:
            left = None if deadline is None else deadline - time.monotonic()
            if not wait([p.sentinel for p in running],
                        None if left is None else max(left, 0.0)):
                raise TimeoutError(f"{world} worker ranks still running after "
                                   f"{timeout_s} s")
            running = [p for p in running if p.exitcode is None]
            if any(p.exitcode for p in procs if p.exitcode is not None):
                break                       # one failed: stop the others
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        if failed:
            logs = [Path(rundir, f"error{r}.txt") for r, _ in failed]
            raise RuntimeError(
                f"worker ranks failed (rank, exit code): {failed}\n"
                + "\n".join(f.read_text() for f in logs if f.exists()))
        return torch.load(Path(rundir, "result.pt"), weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        if own_tracker:
            tracker._stop()          # closes its pipe, then waits for it
        shutil.rmtree(rundir, ignore_errors=True)
