"""Multi-host warm-up coordination and the persistent compile cache
(counterpart of `repro/distributed/coordination.py`, DESIGN §8.1).

The bucketed engine makes a batch increase a cache hit on ONE host; a
fleet needs the rung transition to be a hit on EVERY host at the SAME
step.  `Coordinator` is the small protocol the engine consumes:

* ``barrier(name)``      — rung-entry barrier; returns the seconds THIS host
                           waited for the fleet (``EngineStats.barrier_wait_s``).
* ``agree(topic, p)``    — warm-up agreement: the leader's (rank 0) proposal
                           wins and is returned to everyone.
* ``broadcast_failure``  / ``poll_failures`` — one host's warm-up failure
                           downgrades every host to the synchronous build.

Implementations:

* `NoOpCoordinator`      — single host; every operation is free.
* `FileCoordinator`      — a shared directory: rank files in a
                           per-(name, generation) barrier directory, an
                           atomic write-once agreement file from the leader,
                           failure marker files, and a heartbeat file a rank
                           whose staleness names it DEAD.  It uses no
                           framework, so this is the reference's class: the
                           two packages' ranks meet in one directory.
* `DistributedCoordinator` — `torch.distributed` runs, on a gloo group of
                           its own: a barrier is `monitored_barrier` with the
                           call's timeout (it names the ranks that never
                           arrived), followed by an all-gather of each
                           host's failed-rung tags; agreement is a broadcast
                           from rank 0.

The persistent compile cache (`enable_persistent_cache`) maps the
reference's XLA cache onto what the port compiles: the kernels' shared
libraries.  With a cache directory they are built into, and loaded from,
``<dir>/nvcc-<version>-sm_90a-<sources digest>/``
(`repro_torch.kernels.use_cache_dir`), so a restarted or late-joining
worker loads them instead of running nvcc; `disk_cache_hits` counts those
loads.
"""

from __future__ import annotations

import datetime
import os
import re
import threading
import time
import zlib

from repro_torch.testing.faults import fault_point


class CoordinationError(TimeoutError):
    """A coordination operation failed with structured blame: which ranks
    never arrived, and which of those are provably DEAD (their liveness
    heartbeat went stale after having been seen).  Subclasses TimeoutError
    so callers that catch the bare timeout keep working.

    The train driver catches this to checkpoint and exit instead of
    hanging the surviving ranks (DESIGN §12)."""

    def __init__(self, message: str, *, missing=(), dead=()):
        super().__init__(message)
        self.missing_ranks = tuple(missing)
        self.dead_ranks = tuple(dead)


def _blame(missing, dead) -> str:
    parts = []
    if missing:
        parts.append(f"missing ranks: {sorted(missing)}")
    if dead:
        parts.append(f"dead ranks (stale heartbeat): {sorted(dead)}")
    return "; ".join(parts) if parts else "all ranks present"


# ------------------------------------------------------------ protocol ----

class Coordinator:
    """What the bucketed engine needs from a multi-host rendezvous layer."""

    rank: int = 0
    world: int = 1

    def barrier(self, name: str, timeout: float | None = None) -> float:
        """Block until all `world` hosts reach `name`; return seconds waited."""
        raise NotImplementedError

    def agree(self, topic: str, payload: str) -> str:
        """Return the leader's `payload` for `topic` on every host."""
        raise NotImplementedError

    def broadcast_failure(self, tag: str) -> None:
        """Mark `tag` (a rung key digest) as failed fleet-wide."""
        raise NotImplementedError

    def poll_failures(self) -> frozenset:
        """Tags any host has marked failed (non-blocking; may lag until the
        next synchronization point on collective-backed impls)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoOpCoordinator(Coordinator):
    """Single host: barriers are free, agreement echoes the proposal."""

    def barrier(self, name, timeout=None):
        return 0.0

    def agree(self, topic, payload):
        return payload

    def broadcast_failure(self, tag):
        pass

    def poll_failures(self):
        return frozenset()


# ------------------------------------------------------ file coordinator ----

def _fs_safe(name: str) -> str:
    """Filesystem-safe, collision-free token for an arbitrary name."""
    stem = re.sub(r"[^A-Za-z0-9_.x-]", "_", name)[:48]
    return f"{stem}-{zlib.crc32(name.encode()) & 0xFFFFFFFF:08x}"


class FileCoordinator(Coordinator):
    """Shared-directory rendezvous for multi-process runs (the reference's
    layout, file for file).

    Writers create files atomically (`os.replace` from a rank-private
    temp), readers poll.  The directory is append-only during a run —
    barrier generations, agreement topics and failure markers all get
    fresh paths — so a slow host never misses an event that faster hosts
    already consumed.  `run_id` namespaces the directory per job
    (`root/<run_id>/...`); within one run_id a restarted worker re-running
    the same deterministic step sequence sails through the barriers the
    fleet already passed.

    Liveness (DESIGN §12): a daemon thread refreshes ``hb/<rank>`` every
    `heartbeat_s`; a rank whose heartbeat was seen but is stale by more
    than `dead_after` seconds is DEAD.  A barrier whose missing ranks are
    all dead fails fast with a `CoordinationError` naming them; a rank that
    never wrote a heartbeat is only *missing* and gets the whole timeout.
    Polling backs off from `poll_s` to `poll_max_s`.  ``REPRO_COORD_HEARTBEAT_S``
    and ``REPRO_COORD_DEAD_AFTER_S`` set the two liveness defaults.
    """

    def __init__(self, root: str, rank: int, world: int, *,
                 timeout: float = 120.0, poll_s: float = 0.005,
                 poll_max_s: float = 0.05, heartbeat_s: float | None = None,
                 dead_after: float | None = None, run_id: str = ""):
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"bad coordinator geometry rank={rank} world={world}")
        self.root = os.path.abspath(
            os.path.join(root, _fs_safe(run_id)) if run_id else root)
        self.rank, self.world = rank, world
        self.timeout, self.poll_s = timeout, poll_s
        self.poll_max_s = max(poll_max_s, poll_s)
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None else float(
            os.environ.get("REPRO_COORD_HEARTBEAT_S", "1.0")))
        self.dead_after = (dead_after if dead_after is not None else float(
            os.environ.get("REPRO_COORD_DEAD_AFTER_S",
                           str(10.0 * self.heartbeat_s))))
        self._gens: dict[str, int] = {}     # per-name barrier generation
        self._hb_dir = os.path.join(self.root, "hb")
        os.makedirs(self._hb_dir, exist_ok=True)
        self._stop = threading.Event()
        self._beat()                         # visible before any barrier
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"coord-hb-{rank}", daemon=True)
        self._hb_thread.start()

    # ------------------------------------------------------------ liveness --

    def _beat(self) -> None:
        self._atomic_write(os.path.join(self._hb_dir, str(self.rank)),
                           repr(time.time()))

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._beat()
            except OSError:          # a transient filesystem error: the
                continue             # next beat repairs the staleness

    def dead_ranks(self) -> frozenset:
        """Ranks whose heartbeat was SEEN but is now stale by > dead_after.
        Never-seen ranks are not here: they may still be launching."""
        now = time.time()
        dead = set()
        for r in range(self.world):
            if r == self.rank:
                continue
            p = os.path.join(self._hb_dir, str(r))
            try:
                if now - os.path.getmtime(p) > self.dead_after:
                    dead.add(r)
            except OSError:
                continue             # no heartbeat yet: unknown, not dead
        return frozenset(dead)

    def close(self) -> None:
        self._stop.set()
        if self._hb_thread.is_alive():
            self._hb_thread.join(timeout=2 * self.heartbeat_s + 1.0)

    # ---------------------------------------------------------- primitives --

    def _atomic_write(self, path: str, content: str) -> None:
        tmp = f"{path}.tmp{self.rank}"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)

    def _poll_wait(self, waited_polls: int) -> None:
        time.sleep(min(self.poll_s * (2 ** min(waited_polls, 16)),
                       self.poll_max_s))

    def barrier(self, name, timeout=None):
        timeout = self.timeout if timeout is None else timeout
        fault_point("coord.barrier", name=name, rank=self.rank)
        gen = self._gens[name] = self._gens.get(name, 0) + 1
        d = os.path.join(self.root, "barrier", f"{_fs_safe(name)}.{gen}")
        os.makedirs(d, exist_ok=True)
        self._atomic_write(os.path.join(d, str(self.rank)), "")
        t0 = time.monotonic()
        polls = 0
        while True:
            present = set()
            for f in os.listdir(d):
                try:                 # skip in-flight .tmp<rank> writes
                    present.add(int(f))
                except ValueError:
                    continue
            if len(present) >= self.world:
                return time.monotonic() - t0
            missing = set(range(self.world)) - present
            dead = self.dead_ranks() & missing
            timed_out = time.monotonic() - t0 > timeout
            if timed_out or (missing and missing <= dead):
                # every missing rank provably died: waiting out the
                # timeout cannot change the outcome
                raise CoordinationError(
                    f"coordination barrier {name!r} (generation {gen}): "
                    f"{len(present)}/{self.world} hosts arrived"
                    + (f" within {timeout:.1f}s" if timed_out else
                       " and every missing rank's heartbeat is stale")
                    + f" — {_blame(missing, dead)}; coordination dir: "
                    f"{self.root}", missing=missing, dead=dead)
            self._poll_wait(polls)
            polls += 1

    def agree(self, topic, payload):
        d = os.path.join(self.root, "agree")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _fs_safe(topic))
        if self.rank == 0:
            # write-once: a restarted leader republishes the SAME value,
            # never clobbers a decision followers may have consumed
            if not os.path.exists(path):
                self._atomic_write(path, payload)
            with open(path) as f:
                return f.read()
        t0 = time.monotonic()
        polls = 0
        while not os.path.exists(path):
            leader_dead = 0 in self.dead_ranks()
            if time.monotonic() - t0 > self.timeout or leader_dead:
                raise CoordinationError(
                    f"warmup agreement {topic!r}: leader (rank 0) published "
                    "nothing"
                    + (" and its heartbeat is stale" if leader_dead else
                       f" within {self.timeout:.1f}s")
                    + f" (coordination dir: {self.root})",
                    missing=(0,), dead=((0,) if leader_dead else ()))
            self._poll_wait(polls)
            polls += 1
        with open(path) as f:
            return f.read()

    def broadcast_failure(self, tag):
        d = os.path.join(self.root, "fail")
        os.makedirs(d, exist_ok=True)
        self._atomic_write(os.path.join(d, _fs_safe(tag)), tag)

    def poll_failures(self):
        d = os.path.join(self.root, "fail")
        if not os.path.isdir(d):
            return frozenset()
        tags = set()
        for entry in os.listdir(d):
            if entry.endswith(f".tmp{self.rank}"):
                continue
            try:
                with open(os.path.join(d, entry)) as f:
                    tags.add(f.read())
            except OSError:      # another rank's temp file vanished mid-list
                continue
        return frozenset(tags)


# ---------------------------------------------- torch.distributed backend ----

# gloo's words for the ranks a monitored barrier missed: "[Rank 0]: Ranks
# 1, 3 failed to pass monitoredBarrier in 2000 ms"
_RANKS_RE = re.compile(r"Ranks?\s+([0-9][0-9, ]*?)\s+failed to pass")


class DistributedCoordinator(Coordinator):
    """Coordination over `torch.distributed` (the default process group
    must be initialised).  It makes a gloo group of its own at
    construction (every rank constructs it, in the same order), so the
    barrier can be `monitored_barrier`, which takes a per-call timeout and
    names the ranks that did not arrive, whatever backend the training
    collectives use.

    * `barrier` — `monitored_barrier(timeout)`, then an all-gather of each
      host's failed-rung tags: the failure exchange rides on the barrier,
      so by the time anyone crosses a rung-entry barrier the whole fleet
      shares one failure view.  A rank that does not arrive is a
      `CoordinationError` naming it (its liveness is the group's: a dead
      rank and a late one look alike).
    * `agree` — `broadcast_object_list` from rank 0.
    * `poll_failures` — the view as of the last barrier plus this host's
      own failures (the engine reads it at rung entry, next to the
      barrier that refreshes it)."""

    def __init__(self, timeout: float = 120.0):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("--coord=distributed needs an initialised "
                               "torch.distributed process group")
        self._dist = dist
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.timeout = timeout
        self._pg = dist.new_group(backend="gloo")
        self._local: set[str] = set()
        self._known: set[str] = set()

    def barrier(self, name, timeout=None):
        dist = self._dist
        timeout = self.timeout if timeout is None else timeout
        fault_point("coord.barrier", name=name, rank=self.rank)
        t0 = time.monotonic()
        try:
            dist.monitored_barrier(group=self._pg, wait_all_ranks=True,
                                   timeout=datetime.timedelta(seconds=timeout))
            rows = [None] * self.world
            dist.all_gather_object(rows, sorted(self._local), group=self._pg)
        except Exception as e:   # the group found a peer missing
            found = _RANKS_RE.search(str(e))
            missing = (tuple(int(x) for x in re.findall(r"\d+", found.group(1)))
                       if found else ())
            raise CoordinationError(
                f"distributed barrier {name!r} failed across {self.world} "
                f"processes within {timeout:.1f}s — "
                f"{_blame(missing, ())}: {e}", missing=missing) from e
        for row in rows:
            self._known.update(row)
        return time.monotonic() - t0

    def agree(self, topic, payload):
        box = [payload if self.rank == 0 else None]
        try:
            self._dist.broadcast_object_list(box, src=0, group=self._pg)
        except Exception as e:
            raise CoordinationError(
                f"distributed agreement {topic!r} failed (leader or a peer "
                f"died mid-broadcast): {e}", missing=(0,)) from e
        return box[0]

    def broadcast_failure(self, tag):
        self._local.add(tag)

    def poll_failures(self):
        return frozenset(self._known | self._local)

    def close(self) -> None:
        if self._pg is not None:
            self._dist.destroy_process_group(self._pg)
            self._pg = None


# -------------------------------------------------------------- factory ----

def make_coordinator(kind: str, *, root: str = "", rank: int = -1,
                     world: int = 0, timeout: float = 120.0,
                     run_id: str = ""):
    """Resolve `--coord={none,file,distributed}` into a Coordinator (or None
    for `none`: the engine's coordination hooks vanish, bit-identical to the
    uncoordinated engine).  `file` geometry comes from the explicit args,
    then `REPRO_COORD_RANK` / `REPRO_COORD_WORLD`; `run_id` namespaces the
    shared directory per job."""
    if kind in ("none", "", None):
        return None
    if kind == "file":
        if not root:
            raise ValueError("--coord=file needs --coord-dir (a directory "
                             "shared by every host)")
        rank = rank if rank >= 0 else int(os.environ.get("REPRO_COORD_RANK", "0"))
        world = world or int(os.environ.get("REPRO_COORD_WORLD", "1"))
        return FileCoordinator(root, rank, world, timeout=timeout,
                               run_id=run_id)
    if kind == "distributed":
        return DistributedCoordinator(timeout=timeout)
    raise ValueError(f"unknown coordinator kind {kind!r} "
                     "(expected none|file|distributed)")


# ------------------------------------------- persistent compile cache ----

def enable_persistent_cache(cache_dir: str) -> str:
    """Build the kernels' libraries into, and load them from, `cache_dir`
    for this process.  Each toolchain and source state gets a directory of
    its own under it (nvcc version, sm_90a, a digest of every source), so
    restarted or late-joining workers of a job load the libraries the
    first one built and an edited source or another nvcc never loads a
    stale one.  Returns `cache_dir`, absolute."""
    from repro_torch import kernels
    return str(kernels.use_cache_dir(cache_dir))


def disk_cache_hits() -> int:
    """Kernel libraries this process loaded from the persistent cache
    instead of building (0 until `enable_persistent_cache`)."""
    from repro_torch import kernels
    return kernels.cache_hits()


__all__ = [
    "CoordinationError", "Coordinator", "NoOpCoordinator", "FileCoordinator",
    "DistributedCoordinator", "make_coordinator",
    "enable_persistent_cache", "disk_cache_hits",
]
