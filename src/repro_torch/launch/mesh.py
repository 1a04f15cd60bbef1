"""Data-parallel workers on `torch.distributed` (counterpart of
`repro/launch/mesh.py`).

The reference's norm-test workers are the instances of a `shard_map` over
the mesh's data axes; here each worker j is one process, rank j of the
default process group, and a collective over the data axes is a
collective over that group.  J = 1 means no group and no collective.

* `num_workers`, `worker_index` — J and j of this process;
* `psum`, `pmean` — the reference's reductions over the data axes;
* `init_workers` — join the group as one rank (the caller names the
  backend: "nccl" needs a card per rank, "gloo" lets ranks share a card or
  run on the CPU; nothing switches silently);
* `spawn_workers` — run a function on J new local processes, one rank
  each, and return rank 0's result.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from multiprocessing import resource_tracker
from multiprocessing.connection import wait
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def num_workers() -> int:
    """J: the number of data-parallel workers (1 outside a process group)."""
    return dist.get_world_size() if _grouped() else 1


def worker_index() -> int:
    """j ∈ [0, J): this process's worker index (its rank)."""
    return dist.get_rank() if _grouped() else 0


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the workers, IN PLACE; one worker: `x` itself."""
    if num_workers() > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean of `x` over the workers, as a new tensor."""
    return psum(x.clone()) / num_workers()


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
