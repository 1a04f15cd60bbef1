"""The port's rung cache and bucketed engine (`repro_torch.distributed.
engine`), on the CPU, against the reference's `engine.py`:

* `RungCache`: exactly one build a key under concurrent callers; warm-up
  retries with backoff, exactly-once failure accounting, `drain` raising;
  the fault sites `engine.compile` and `engine.warmup_compile`;
* `BucketedEngine`: the stats equal the reference engine's on the same
  ladder and plan sequence (warm-up on); `warmup_agreed` with a desync; a
  remote failure downgrading a queued warm-up; a host's own warm-up
  failure broadcast before it is consumed;
* two processes training through a file coordinator over a stagewise
  batch increase: the increase is a cache hit on both, losses equal;
* launch counts under graph replay (`ops.capturing`, `ops.CountedGraph`)
  with a stub graph.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (thread cap)

from repro.core.schedule import parse_ladder as jparse_ladder
from repro.data.pipeline import MarkovTokens as JMarkov, make_batch as jmake_batch
from repro.data.pipeline import pad_to_bucket as jpad
from repro.distributed.engine import BucketedEngine as JBucketedEngine
from repro_torch.core.schedule import parse_ladder
from repro_torch.data.pipeline import MarkovTokens, make_batch, pad_to_bucket
from repro_torch.distributed import engine as engine_mod
from repro_torch.distributed.coordination import FileCoordinator
from repro_torch.distributed.engine import BucketedEngine, RungCache
from repro_torch.kernels import ops
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


class _Counting(RungCache):
    """A rung cache whose builds take `delay` seconds and are logged."""

    def __init__(self, delay=0.0, fail_warm=0, **kw):
        super().__init__(**kw)
        self.delay, self.fail_warm, self.built = delay, fail_warm, []
        self._log = threading.Lock()

    def _build(self, arg):
        time.sleep(self.delay)
        with self._log:
            self.built.append(arg)
        return lambda: arg

    def _aot_build(self, arg):
        if self.fail_warm:
            self.fail_warm -= 1
            raise RuntimeError(f"warm-up of {arg} failed")
        return self._build(arg)


# ------------------------------------------------------------ RungCache ----

def test_one_build_a_key_under_concurrent_callers():
    cache = _Counting(delay=0.2)
    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.lookup(("k",), 7)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cache.built == [7]                       # ONE build
    assert len({id(f) for f in got}) == 1 and got[0]() == 7
    assert cache.stats.compiles == 1 and cache.stats.hits == 7
    assert cache.cached(("k",)) and not cache.cached(("other",))


def test_warmup_retries_with_backoff_then_succeeds():
    cache = _Counting(aot=True, fail_warm=2, warmup_retries=2,
                      warmup_backoff_s=0.01)
    assert cache.submit_warmup(("k",), 3)
    assert not cache.submit_warmup(("k",), 3)      # pending: no second job
    cache.drain()
    assert cache.stats.warmup_retries == 2
    assert cache.stats.warmups == cache.stats.compiles == 1
    assert cache.stats.warmup_failures == 0 and cache.cached(("k",))
    assert not cache.submit_warmup(("k",), 3)      # built: no-op


def test_permanent_warmup_failure_is_counted_once_and_drain_raises():
    """A warm-up that fails past its retries: the lookup that claims it
    records it once and builds in the foreground; `drain` re-raises it
    once; a second drain is quiet."""
    fired = []

    class Hooked(_Counting):
        def _on_warmup_build_failure(self, key):
            fired.append(key)

    cache = Hooked(aot=True, fail_warm=10, warmup_retries=1, warmup_backoff_s=0.001)
    cache.submit_warmup(("k",), 5)
    fn = cache.lookup(("k",), 5)                    # claims the failure
    assert fn() == 5 and cache.built == [5]         # the foreground build
    assert fired == [("k",)]                        # the hook, once
    assert cache.stats.warmup_failures == 1 and cache.stats.warmup_retries == 1
    assert cache.stats.warmups == 0 and cache.stats.compiles == 1
    with pytest.raises(RuntimeError, match="1 AOT warmup compile"):
        cache.drain()
    cache.drain()                                   # already surfaced
    assert cache.stats.warmup_failures == 1
    # a failure claimed by drain itself counts once too
    cache.submit_warmup(("j",), 6)
    with pytest.raises(RuntimeError, match="warmup compile"):
        cache.drain()
    assert cache.stats.warmup_failures == 2


def test_fault_sites_engine_compile_and_warmup_compile():
    cache = _Counting(aot=True)
    with faults.inject(FaultRule(site="engine.warmup_compile", at=1, count=1)):
        cache.submit_warmup(("w",), 1)
        cache.drain()                              # transient: one retry
    assert cache.stats.warmup_retries == 1 and cache.stats.warmups == 1
    with faults.inject(FaultRule(site="engine.compile", at=1, count=1)):
        with pytest.raises(faults.InjectedFault):
            cache.lookup(("f",), 2)
        assert cache.lookup(("f",), 2)() == 2      # the next call builds
    assert cache.stats.compiles == 2


# ------------------------------------------------------- BucketedEngine ----

def _j_wrap(batch_like):
    return jax.jit(lambda p, o, b, lr: (p, o, {"loss": sum(
        jnp.sum(v) for v in b.values())}))


def test_engine_stats_equal_reference_on_the_same_plan_sequence():
    """The same ladder, plans, padding and warm-ups through both engines
    (warm-up on, uncoordinated): every counter but the wall-clock ones is
    equal."""
    spec = "2:1,2:2,4:2,4:4"
    jeng = JBucketedEngine(_j_wrap, jparse_ladder(spec, workers=1),
                           params_like={}, opt_like={}, aot_warmup=True)
    teng = BucketedEngine(lambda bl: (lambda *a: None), parse_ladder(spec, workers=1),
                          aot_warmup=True)
    # (micro, accum) of each step's plan
    plans = [(2, 2), (2, 2), (2, 3), (4, 2), (2, 4), (4, 4), (4, 3), (4, 4), (2, 2)]
    for eng, mk, pad, src in ((jeng, jmake_batch, jpad, JMarkov(vocab_size=64, seed=0)),
                              (teng, make_batch, pad_to_bucket,
                               MarkovTokens(vocab_size=64, seed=0))):
        for step, (mb, acc) in enumerate(plans):
            plan = type(eng.ladder[0])(global_batch=mb * acc, micro_batch=mb,
                                       accum_steps=acc, workers=1)
            bucket = eng.bucket_for(plan.global_batch)
            batch = pad(mk(src, step, plan, 8), plan, bucket)
            eng.get_step(batch)
            eng.observe(plan, bucket)
            eng.warmup_agreed(bucket, batch)
        eng.drain()
    want, got = jeng.stats.as_dict(), teng.stats.as_dict()
    for k in ("barrier_wait_s", "disk_cache_hits"):
        want.pop(k), got.pop(k)
    assert got == want
    assert got["warmups"] >= 1 and got["transition_hits"] >= 1


def test_warmup_agreed_desync_adopts_the_leaders_rung(tmp_path):
    ladder = parse_ladder("2:1,2:2,2:4", workers=1)
    engines = [BucketedEngine(lambda bl: (lambda *a: None), ladder, aot_warmup=True,
                              coordinator=FileCoordinator(str(tmp_path / "c"), r, 2))
               for r in range(2)]
    batch = make_batch(MarkovTokens(vocab_size=32, seed=0), 0, ladder[0], 4)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        f=engines[1].warmup_agreed(ladder[0], batch, proposal=ladder[2])))
    t.start()
    out["l"] = engines[0].warmup_agreed(ladder[0], batch)   # proposes ladder[1]
    t.join()
    assert out == {"l": ladder[1], "f": ladder[1]}
    assert engines[0].stats.desyncs == 0 and engines[1].stats.desyncs == 1
    # the same (bucket, proposal) again: no new agreement topic
    assert engines[1].warmup_agreed(ladder[0], batch, proposal=ladder[2]) == ladder[1]
    for e in engines:
        e.drain()
        assert e.stats.warmups == 1
        e._coord.close()


def test_remote_failure_downgrades_queued_warmup(tmp_path):
    """A rung another host flagged gets its queued-not-started warm-up
    cancelled at rung entry (`coord_downgrades`) and is built in the
    foreground; no warm-up failure is charged to THIS host."""
    coord_a = FileCoordinator(str(tmp_path / "c"), 0, 2)
    coord_b = FileCoordinator(str(tmp_path / "c"), 1, 2)
    ladder = parse_ladder("2:1,2:2,2:4", workers=1)
    gate = threading.Event()
    built = []

    def wrap(batch_like):
        built.append(tuple(v.shape for v in batch_like.values()))
        if len(built) == 1:       # the first warm-up blocks the worker
            gate.wait(timeout=30)
        return lambda *a: None

    eng = BucketedEngine(wrap, ladder, aot_warmup=True, coordinator=coord_b)
    src = MarkovTokens(vocab_size=32, seed=0)
    batch0 = make_batch(src, 0, ladder[0], 4)
    eng.warmup(ladder[1], batch0)      # running (blocked)
    eng.warmup(ladder[2], batch0)      # queued behind it
    batch2 = make_batch(src, 1, ladder[2], 4)
    tag = engine_mod._key_tag(engine_mod._batch_key(batch2))
    coord_a.broadcast_failure(tag)
    t = threading.Thread(target=lambda: coord_a.barrier(f"rung-{tag}"))
    t.start()
    assert eng.get_step(batch2) is not None
    t.join()
    assert eng.stats.coord_downgrades == 1
    assert eng.stats.warmup_failures == 0 and eng.stats.barriers == 1
    gate.set()
    eng.drain()
    assert eng.stats.warmups == 1
    coord_a.close(), coord_b.close()


def test_engine_broadcasts_own_warmup_failure_promptly(tmp_path):
    coord = FileCoordinator(str(tmp_path / "c"), 0, 2)
    observer = FileCoordinator(str(tmp_path / "c"), 1, 2)
    ladder = parse_ladder("2:1,2:2", workers=1)

    def wrap(batch_like):
        raise RuntimeError("boom")

    eng = BucketedEngine(wrap, ladder, aot_warmup=True, coordinator=coord,
                         warmup_backoff_s=0.001)
    eng.warmup(ladder[1], make_batch(MarkovTokens(vocab_size=32, seed=0), 0,
                                     ladder[0], 4))
    deadline = time.monotonic() + 10
    while not observer.poll_failures():
        assert time.monotonic() < deadline, "failure never broadcast"
        time.sleep(0.01)
    assert eng.stats.warmup_failures == 0        # consumption-time, once
    with pytest.raises(RuntimeError, match="warmup compile"):
        eng.drain()
    assert eng.stats.warmup_failures == 1
    coord.close(), observer.close()


_TWO_PROC_TRAIN = """
import json, sys
from repro_torch.launch.train import TrainJob, run_training
rank, coord_dir = int(sys.argv[1]), sys.argv[2]
job = TrainJob(arch="llama3.2-1b", schedule="stagewise",
               stages=((0.5, 4), (0.5, 8)), steps=12, total_samples=48,
               seq_len=16, base_global_batch=4, max_global_batch=8,
               base_micro_batch=2, max_micro_batch=2, base_accum=2,
               step_impl="accum_norm", eval_every=0, aot_warmup=True,
               coord="file", coord_dir=coord_dir, coord_rank=rank,
               coord_world=2, coord_timeout=120.0, device="cpu")
h = run_training(job)
print("HIST", json.dumps({"rank": rank, "loss": h["loss"],
                          "gb": h["global_batch"], "engine": h["engine"]}))
"""


def test_two_process_training_over_batch_increase(tmp_path):
    """`run_training` on two file-coordinated processes across a stagewise
    4 -> 8 increase: the only foreground build is the first rung on BOTH
    hosts (the increase rode the agreed warm-up), two rung-entry barriers
    each, no desync, and equal loss histories."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROC_TRAIN, str(r),
                               str(tmp_path / "coord")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    hists = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
        line = next(l for l in out.splitlines() if l.startswith("HIST"))
        hists.append(json.loads(line.split(" ", 1)[1]))
    for h in hists:
        eng = h["engine"]
        assert max(h["gb"]) == 8 and min(h["gb"]) == 4
        assert eng["warmup_failures"] == 0 and eng["desyncs"] == 0
        assert eng["compiles"] - eng["warmups"] == 1, eng
        assert eng["hits"] == eng["steps"] - 1, eng
        assert eng["transitions"] == eng["transition_hits"] == 1, eng
        assert eng["barriers"] == 2, eng
    assert hists[0]["loss"] == hists[1]["loss"]


# ---------------------------------------------- launch counts under replay ----

class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_replays_add_their_captured_launches():
    """Launches recorded while capturing are taken back out of the
    wrappers' counts; each replay of the graph adds them again."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    ops.reset_launch_counts()
    rmsnorm.launches += 1                       # one eager launch
    with ops.capturing() as captured:
        rmsnorm.launches += 33                  # what a capture records
        flash_attention.launches += 2
    assert ops.launch_counts()["rmsnorm"] == 1  # capturing launches nothing
    assert captured["rmsnorm"] == 33 and captured["flash_attention"] == 2
    graph = ops.CountedGraph(_StubGraph(), captured)
    for _ in range(3):
        graph.replay()
    counts = ops.launch_counts()
    assert graph.graph.replays == 3
    assert counts["rmsnorm"] == 1 + 3 * 33 and counts["flash_attention"] == 6
    assert counts["fused_adamw_stats"] == 0
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
