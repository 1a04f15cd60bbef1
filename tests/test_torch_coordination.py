"""Multi-host warm-up coordination in the port (`repro_torch.distributed.
coordination`), on the CPU, against the reference's framework-free cases
(`tests/test_coordination.py`):

* the port's `FileCoordinator` meets the reference's own in ONE directory
  (barriers, generations, agreement, failures: the same file layout);
* the file coordinator's barrier, generations, typed timeouts naming the
  missing ranks, write-once agreement, failure broadcast, liveness (a dead
  rank fails fast, a live one never reads as dead), the no-op coordinator
  and `make_coordinator`'s resolution;
* `DistributedCoordinator` on a gloo world of one;
* `--coord none` bit-identical to a file-coordinated world of one;
* the persistent compile cache's directory and hit counter.
"""

import threading
import time

import pytest
import torch
import torch.distributed as dist

from repro.distributed.coordination import FileCoordinator as JFileCoordinator
from repro_torch import kernels
from repro_torch.distributed import coordination as coord_mod
from repro_torch.distributed.coordination import (
    CoordinationError, DistributedCoordinator, FileCoordinator, NoOpCoordinator,
    disk_cache_hits, enable_persistent_cache, make_coordinator)


def _pair(tmp_path, **kw):
    d = str(tmp_path / "coord")
    return FileCoordinator(d, 0, 2, **kw), FileCoordinator(d, 1, 2, **kw)


def _in_thread(fn):
    out = {}
    t = threading.Thread(target=lambda: out.update(v=fn()))
    t.start()
    return t, out


# ---------------------------------------- the reference's directory layout ----

def test_port_and_reference_ranks_meet_in_one_directory(tmp_path):
    """Rank 0 is the port's coordinator, rank 1 the reference's, on one
    directory and one run id: barriers of two generations, the leader's
    write-once agreement and the failure markers pass between them."""
    d = str(tmp_path / "coord")
    port = FileCoordinator(d, 0, 2, run_id="job-1")
    ref = JFileCoordinator(d, 1, 2, run_id="job-1")
    assert port.root == ref.root
    for _ in range(2):
        t, out = _in_thread(lambda: ref.barrier("rung-ab"))
        assert port.barrier("rung-ab") >= 0.0
        t.join()
        assert out["v"] >= 0.0
    t, out = _in_thread(lambda: ref.agree("warmup-1", "8x2"))
    assert port.agree("warmup-1", "4x2") == "4x2"
    t.join()
    assert out["v"] == "4x2"
    port.broadcast_failure("deadbeef")
    ref.broadcast_failure("cafe0001")
    assert ref.poll_failures() == port.poll_failures() == {"deadbeef", "cafe0001"}
    assert ref.dead_ranks() == port.dead_ranks() == frozenset()
    port.close(), ref.close()


# ------------------------------------------------------ file coordinator ----

def test_barrier_meets_and_reports_wait(tmp_path):
    c0, c1 = _pair(tmp_path)

    def late():
        time.sleep(0.15)
        return c1.barrier("entry")

    t, out = _in_thread(late)
    wait0 = c0.barrier("entry")       # waits ~0.15 s for rank 1
    t.join()
    assert wait0 >= 0.1 and out["v"] < 5.0
    c0.close(), c1.close()


def test_barrier_generations_allow_reentry(tmp_path):
    """One barrier NAME crossed twice gets a fresh generation each time: a
    third crossing alone times out instead of finding leftover files."""
    c0, c1 = _pair(tmp_path)
    for _ in range(2):
        t, _ = _in_thread(lambda: c1.barrier("rung-abc"))
        c0.barrier("rung-abc")
        t.join()
    with pytest.raises(TimeoutError, match="1/2"):
        c1.barrier("rung-abc", timeout=0.2)
    c0.close(), c1.close()


def test_barrier_timeout_is_typed_and_names_missing_ranks(tmp_path):
    c0, c1 = _pair(tmp_path, timeout=0.25)
    with pytest.raises(CoordinationError) as ei:
        c0.barrier("rung-solo")
    assert ei.value.missing_ranks == (1,)
    assert ei.value.dead_ranks == ()            # its heartbeat is fresh
    assert "missing ranks: [1]" in str(ei.value) and "1/2" in str(ei.value)
    assert isinstance(ei.value, TimeoutError)
    c0.close(), c1.close()


def test_agreement_leader_wins_and_is_write_once(tmp_path):
    c0, c1 = _pair(tmp_path)
    t, out = _in_thread(lambda: c1.agree("warmup-1", "8x2"))
    assert c0.agree("warmup-1", "4x2") == "4x2"
    t.join()
    assert out["v"] == "4x2"                     # the follower adopted it
    assert c0.agree("warmup-1", "16x1") == "4x2"  # a restarted leader
    c0.close(), c1.close()


def test_agreement_follower_timeout(tmp_path):
    c0, c1 = _pair(tmp_path, timeout=0.25)
    with pytest.raises(TimeoutError, match="warmup-9"):
        c1.agree("warmup-9", "4x2")
    c0.close(), c1.close()


def test_failure_broadcast_is_fleet_visible_and_idempotent(tmp_path):
    c0, c1 = _pair(tmp_path)
    assert c1.poll_failures() == frozenset()
    c0.broadcast_failure("deadbeef")
    c0.broadcast_failure("deadbeef")
    assert c1.poll_failures() == frozenset({"deadbeef"})
    c1.broadcast_failure("cafe0001")
    assert c0.poll_failures() == frozenset({"deadbeef", "cafe0001"})
    c0.close(), c1.close()


def test_noop_coordinator_is_free():
    c = NoOpCoordinator()
    assert c.barrier("x") == 0.0
    assert c.agree("t", "4x2") == "4x2"
    c.broadcast_failure("x")
    assert c.poll_failures() == frozenset()


def test_make_coordinator_resolution(tmp_path, monkeypatch):
    assert make_coordinator("none") is None
    with pytest.raises(ValueError, match="coord-dir"):
        make_coordinator("file")
    with pytest.raises(ValueError, match="unknown"):
        make_coordinator("gossip", root=str(tmp_path))
    monkeypatch.setenv("REPRO_COORD_RANK", "1")
    monkeypatch.setenv("REPRO_COORD_WORLD", "3")
    c = make_coordinator("file", root=str(tmp_path / "c"))
    assert (c.rank, c.world) == (1, 3)
    explicit = make_coordinator("file", root=str(tmp_path / "c"), rank=0, world=2)
    assert (explicit.rank, explicit.world) == (0, 2)
    a = make_coordinator("file", root=str(tmp_path / "c"), rank=0, world=1,
                         run_id="job-aaaa")
    b = make_coordinator("file", root=str(tmp_path / "c"), rank=0, world=1,
                         run_id="job-bbbb")
    assert a.root != b.root
    a.broadcast_failure("dead")
    assert b.poll_failures() == frozenset()     # isolated namespaces
    with pytest.raises(ValueError, match="geometry"):
        FileCoordinator(str(tmp_path / "c"), rank=5, world=2)
    with pytest.raises(RuntimeError, match="process group"):
        make_coordinator("distributed")
    for x in (c, explicit, a, b):
        x.close()


def test_barrier_fails_fast_when_missing_rank_is_dead(tmp_path):
    d = str(tmp_path / "coord")
    c1 = FileCoordinator(d, 1, 2, heartbeat_s=0.05, dead_after=0.3)
    c1.close()                                  # rank 1 stops beating
    c0 = FileCoordinator(d, 0, 2, heartbeat_s=0.05, dead_after=0.3, timeout=60.0)
    time.sleep(0.45)
    t0 = time.monotonic()
    with pytest.raises(CoordinationError) as ei:
        c0.barrier("rung-x")
    assert time.monotonic() - t0 < 10.0         # fail fast, not 60 s
    assert ei.value.dead_ranks == (1,)
    assert "dead ranks (stale heartbeat): [1]" in str(ei.value)
    c0.close()


def test_agree_fails_fast_when_leader_is_dead(tmp_path):
    d = str(tmp_path / "coord")
    c0 = FileCoordinator(d, 0, 2, heartbeat_s=0.05, dead_after=0.3)
    c0.close()
    c1 = FileCoordinator(d, 1, 2, heartbeat_s=0.05, dead_after=0.3, timeout=60.0)
    time.sleep(0.45)
    t0 = time.monotonic()
    with pytest.raises(CoordinationError, match="heartbeat is stale") as ei:
        c1.agree("warmup-3", "4x2")
    assert time.monotonic() - t0 < 10.0
    assert ei.value.dead_ranks == (0,)
    c1.close()


def test_live_rank_never_reads_as_dead(tmp_path):
    d = str(tmp_path / "coord")
    c0 = FileCoordinator(d, 0, 2, heartbeat_s=0.05, dead_after=0.25)
    c1 = FileCoordinator(d, 1, 2, heartbeat_s=0.05, dead_after=0.25)
    time.sleep(0.5)
    assert c0.dead_ranks() == frozenset()
    c1.close()
    time.sleep(0.5)
    assert c0.dead_ranks() == frozenset({1})
    solo = FileCoordinator(str(tmp_path / "c2"), 0, 3, heartbeat_s=0.05,
                           dead_after=0.25)
    time.sleep(0.4)
    assert solo.dead_ranks() == frozenset()     # never seen: only missing
    solo.close(), c0.close()


# --------------------------------------------- torch.distributed backend ----

def test_distributed_coordinator_world_of_one(tmp_path):
    """On a gloo world of one: free barriers, echo agreement, and the
    barrier's failure exchange keeps local failures visible."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        c = make_coordinator("distributed", timeout=30.0)
        assert isinstance(c, DistributedCoordinator)
        assert (c.rank, c.world) == (0, 1)
        assert c.barrier("rung-x") >= 0.0
        assert c.agree("t1", "4x2") == "4x2"
        c.broadcast_failure("aabbccdd")
        assert "aabbccdd" in c.poll_failures()
        c.barrier("rung-y")
        assert c.poll_failures() == frozenset({"aabbccdd"})
        c.close()
    finally:
        dist.destroy_process_group()


def _two_rank_coordination():
    """One rank of the two-rank case: agreement, the failure exchange at a
    barrier, then a barrier rank 1 never reaches."""
    c = DistributedCoordinator(timeout=30.0)
    out = {"agreed": c.agree("warmup-1", f"{c.rank}x2")}
    if c.rank == 1:
        c.broadcast_failure("rank1-tag")
    c.barrier("rung-a")
    out["failures"] = sorted(c.poll_failures())
    if c.rank == 0:
        try:
            c.barrier("rung-b", timeout=2.0)
        except CoordinationError as e:
            out["missing"] = list(e.missing_ranks)
    else:
        time.sleep(4.0)          # past rank 0's timeout, then leave
    return out


def test_distributed_coordinator_two_ranks():
    """Two gloo ranks: the leader's payload reaches both, a failure marked
    on rank 1 is in rank 0's view after the next barrier, and a barrier
    rank 1 does not reach is a `CoordinationError` naming rank 1."""
    from repro_torch.launch.mesh import spawn_workers
    got = spawn_workers(_two_rank_coordination, 2, timeout_s=120)
    assert got == {"agreed": "0x2", "failures": ["rank1-tag"], "missing": [1]}


def test_distributed_barrier_names_the_rank_that_never_came():
    """The blame a group's failed barrier carries is parsed into the
    missing ranks of a `CoordinationError`."""
    for msg, ranks in (("[Rank 0]: Ranks 1, 3 failed to pass monitoredBarrier "
                        "in 200 ms", [1, 3]),
                       ("[Rank 0]: Ranks 1 failed to pass monitoredBarrier in "
                        "2000 ms", [1])):
        found = coord_mod._RANKS_RE.search(msg)
        assert [int(x) for x in found.group(1).replace(",", " ").split()] == ranks


# ------------------------------------------------------- the loop, coordinated ----

def test_coord_none_bit_identical_to_uncoordinated(tmp_path):
    """`coord="none"` is the uncoordinated engine; a file-coordinated world
    of one (real, free barriers) gives the same losses and engine stats."""
    from repro_torch.launch.train import TrainJob, run_training
    base = dict(arch="llama3.2-1b", steps=6, seq_len=16, base_global_batch=4,
                max_global_batch=16, base_micro_batch=2, max_micro_batch=2,
                base_accum=2, eta=0.12, step_impl="accum_norm", eval_every=0,
                aot_warmup=True, device="cpu")
    h_none = run_training(TrainJob(**base))
    h_solo = run_training(TrainJob(coord="file", coord_dir=str(tmp_path / "c"),
                                   coord_rank=0, coord_world=1, **base))
    assert h_none["loss"] == h_solo["loss"]              # bit-identical
    e_none, e_solo = h_none["engine"], h_solo["engine"]
    for k in ("compiles", "hits", "warmups", "steps", "buckets_used"):
        assert e_none[k] == e_solo[k], k
    assert e_none["barriers"] == 0 and e_solo["barriers"] >= 1
    assert e_solo["desyncs"] == e_solo["coord_downgrades"] == 0


# ------------------------------------------------ persistent compile cache ----

def test_persistent_cache_directory_and_hits(tmp_path, monkeypatch):
    """With a cache directory the libraries' paths move under it, into a
    directory named by nvcc's version, the target and the sources; a
    library already there counts as a disk hit when it loads."""
    monkeypatch.setattr(kernels, "_CACHE", {"root": None, "hits": 0})
    monkeypatch.setattr(kernels, "_toolchain_key",
                        lambda: "nvcc-12.4.131-sm_90a-0123456789abcdef")
    assert kernels.library_path("rmsnorm").parent == kernels.BUILD_DIR
    root = enable_persistent_cache(str(tmp_path / "cc"))
    path = kernels.library_path("rmsnorm")
    assert path.parent == tmp_path / "cc" / "nvcc-12.4.131-sm_90a-0123456789abcdef"
    assert root == str(tmp_path / "cc")
    assert disk_cache_hits() == 0
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")                        # a library built earlier
    loaded = []
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda p: loaded.append(p))
    kernels.load.cache_clear()
    try:
        kernels.load("rmsnorm")                  # found: no nvcc runs
    finally:
        kernels.load.cache_clear()
    assert loaded == [str(path)] and disk_cache_hits() == 1
