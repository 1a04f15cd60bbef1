"""Port continuous-batching tier against the reference, on the CPU: the
serve controller's ladder and decisions, the slot primitives on the
resident cache, the `ServeEngine`'s greedy tokens (staggered joins and
recycled slots included), its rung-cache accounting, admission control,
and `run_continuous_serving` under the same open-loop load.

Parameters come from the reference's init through `params_from_jax`;
tokens, decisions and bookkeeping must be exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import jax_tree_np, rng

from repro.configs import get_smoke_config as jget
from repro.core import serve_controller as jsc
from repro.distributed.serve_engine import ServeEngine as JServeEngine
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import run_continuous_serving as jrun_continuous
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.core import serve_controller as tsc
from repro_torch.distributed.serve_engine import QueueFullError, ServeEngine
from repro_torch.distributed.serve_step import (
    make_slot_decode_step, move_slot, reset_slot, slice_slots, update_slots)
from repro_torch.launch.serve import run_continuous_serving
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves

ARCH = "llama3.2-1b"


# ------------------------------------------------------------ controller --

def test_ladder_and_quantize_match_reference():
    for n in (1, 2, 5, 6, 8, 13, 64):
        assert tsc.serve_ladder(n) == jsc.serve_ladder(n)
        for want in range(0, n + 3):
            assert tsc.quantize_batch(want, tsc.serve_ladder(n)) == \
                jsc.quantize_batch(want, jsc.serve_ladder(n))
    for bad in ((), (2, 1), (0, 1)):
        with pytest.raises(ValueError):
            tsc.ServeControllerConfig(ladder=bad)


@pytest.mark.parametrize("slo", [0.0, 0.05])
def test_controller_decisions_match_reference(slo):
    """A random walk of demand and step latencies through both
    controllers: every state along the way is equal."""
    r = rng(int(slo * 100))
    kw = dict(ladder=(1, 2, 4, 8), latency_slo_s=slo, shrink_patience=3)
    tcfg, jcfg = tsc.ServeControllerConfig(**kw), jsc.ServeControllerConfig(**kw)
    ts, js = tsc.init_serve_controller(tcfg), jsc.init_serve_controller(jcfg)
    for _ in range(300):
        queued, active = int(r.integers(0, 12)), int(r.integers(0, 9))
        ts = tsc.serve_controller_update(tcfg, ts, queued=queued, active=active)
        js = jsc.serve_controller_update(jcfg, js, queued=queued, active=active)
        lat = float(r.uniform(0.0, 0.1))
        ts = tsc.observe_step_latency(tcfg, ts, ts.rung, lat)
        js = jsc.observe_step_latency(jcfg, js, js.rung, lat)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.rung_changes > 0


# ------------------------------------------------- slot-cache primitives --

def test_slot_move_reset_roundtrip_exact():
    model = build_model(get_smoke_config(ARCH))
    cache = model.init_cache(4, 8, device="cpu")
    for layer in cache:
        for x in layer.values():
            x.copy_(torch.arange(1, 5, dtype=x.dtype).view(4, 1, 1, 1).expand_as(x))
    before = [x.clone() for x in tree_leaves(cache)]

    def row(slot):
        return [x[slot] for x in tree_leaves(cache)]

    assert move_slot(cache, 3, 0) is cache
    assert all(torch.equal(a, b[3]) for a, b in zip(row(0), before))
    assert all(torch.equal(a, b[3]) for a, b in zip(row(3), before))
    assert all(torch.equal(a, b[1]) for a, b in zip(row(1), before))
    reset_slot(cache, 3)
    assert all(not a.any() for a in row(3))
    assert all(torch.equal(a, b[3]) for a, b in zip(row(0), before))
    # slice_slots gives views: writes through them land in the buffer
    sub = slice_slots(cache, 2)
    for x in tree_leaves(sub):
        x.fill_(-1.0)
    assert update_slots(cache, sub, 2) is cache
    assert all((a == -1).all() for a in row(0) + row(1))
    assert all(torch.equal(a, b[2]) for a, b in zip(row(2), before))
    # a copy instead of the views is refused (its writes would be lost)
    with pytest.raises(ValueError, match="not a view"):
        update_slots(cache, [{k: x.clone() for k, x in l.items()} for l in sub], 2)
    with pytest.raises(ValueError, match="not a view"):
        update_slots(cache, sub, 3)
    with pytest.raises(ValueError, match="outside resident pool"):
        make_slot_decode_step(model, max_slots=4)(5)


# ----------------------------------------------------------- the engine --

def _pair(max_slots=4, cache_len=16, **kw):
    jcfg, tcfg = jget(ARCH), get_smoke_config(ARCH)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(7))
    tp = params_from_jax(jax_tree_np(jp), tcfg)
    jeng = JServeEngine(jmodel, jp, make_host_mesh(1, 1), max_slots=max_slots,
                        cache_len=cache_len, **kw)
    teng = ServeEngine(tmodel, tp, max_slots=max_slots, cache_len=cache_len, **kw)
    return tcfg, jeng, teng


def _prompts(seed, n, lo, hi, vocab):
    r = np.random.RandomState(seed)
    return [r.randint(0, vocab, size=(r.randint(lo, hi + 1),)).astype(np.int32)
            for _ in range(n)]


BOOKKEEPING = ("steps", "requests_completed", "tokens_generated",
               "prompt_tokens", "slot_resets", "slot_moves", "rung_transitions",
               "padding_waste", "buckets_used")


def _bookkeeping(eng):
    d = eng.stats.as_dict()
    return {k: d[k] for k in BOOKKEEPING}


def test_engine_tokens_identical_to_reference_with_recycled_slots():
    """Five requests of mixed lengths batched continuously (joining,
    leaving, slots compacted), then a second wave into the recycled
    slots: every request's tokens equal the reference engine's."""
    tcfg, jeng, teng = _pair()
    prompts = _prompts(0, 5, 1, 5, tcfg.vocab_size)
    news = [4, 2, 6, 3, 5]
    for wave in (prompts, prompts[:3]):
        jr = [jeng.submit(p, max_new_tokens=n) for p, n in zip(wave, news)]
        tr = [teng.submit(p, max_new_tokens=n) for p, n in zip(wave, news)]
        assert len(jeng.run_until_drained()) == len(teng.run_until_drained())
        for a, b in zip(tr, jr):
            assert a.generated == b.generated, a.rid
    assert _bookkeeping(teng) == _bookkeeping(jeng)
    assert teng.stats.slot_resets == 8 and teng.stats.requests_completed == 8


def test_engine_staggered_joins_identical_to_reference():
    """Requests admitted while others are mid-generation, at different
    positions on their own timelines."""
    tcfg, jeng, teng = _pair(max_slots=4)
    prompts = _prompts(1, 4, 2, 4, tcfg.vocab_size)
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        reqs = [eng.submit(prompts[0], max_new_tokens=6)]
        for p in prompts[1:]:
            for _ in range(2):
                eng.step()
            reqs.append(eng.submit(p, max_new_tokens=5))
        eng.run_until_drained()
        out[name] = [r.generated for r in reqs]
    assert out["torch"] == out["jax"]
    assert _bookkeeping(teng) == _bookkeeping(jeng)


def test_engine_warmed_rung_transition_hits():
    """Warm the ladder, then force rung changes: every transition is a hit
    and nothing new is built."""
    tcfg, _, eng = _pair(max_slots=4, aot_warmup=True)
    eng.warm(eng.ladder)
    assert eng.stats.warmups == eng.stats.compiles == len(eng.ladder)
    for p in _prompts(2, 4, 2, 2, tcfg.vocab_size):
        eng.submit(p, max_new_tokens=3)
    eng.run_until_drained()
    assert eng.stats.compiles == len(eng.ladder)
    assert eng.stats.rung_transitions >= 1
    assert eng.stats.transition_hits == eng.stats.rung_transitions
    assert eng.stats.hit_rate == 1.0


def test_engine_cold_transition_counts_miss():
    tcfg, _, eng = _pair(max_slots=4, aot_warmup=False)
    for p in _prompts(3, 4, 2, 2, tcfg.vocab_size):
        eng.submit(p, max_new_tokens=3)
    eng.run_until_drained()
    assert eng.stats.rung_transitions >= 1
    assert eng.stats.transition_hits == 0
    assert eng.stats.warmups == 0
    assert eng.stats.compiles >= 2
    eng.warm(eng.ladder)                  # warm-up off: a no-op
    assert eng.stats.warmups == 0


def test_engine_submit_validation_and_max_queue():
    tcfg, _, eng = _pair(max_slots=2, cache_len=8, max_queue=3)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((0,), np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(np.zeros((5,), np.int32), max_new_tokens=4)
    prompt = np.array([1, 2], np.int32)
    for _ in range(3):
        eng.submit(prompt, max_new_tokens=2)
    with pytest.raises(QueueFullError) as ei:
        eng.submit(prompt, max_new_tokens=2)
    assert ei.value.queued == 3 and ei.value.max_queue == 3
    assert eng.stats.requests_rejected == 1
    assert eng.stats.requests_submitted == 3 and len(eng.queue) == 3
    eng.run_until_drained()
    eng.submit(prompt, max_new_tokens=2)
    assert len(eng.run_until_drained()) == 1
    assert eng.stats.requests_completed == 4
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    with pytest.raises(ValueError, match="max_queue"):
        ServeEngine(model, params, max_slots=2, cache_len=8, max_queue=-1)
    with pytest.raises(NotImplementedError, match="ring"):
        ServeEngine(model, params, max_slots=2, cache_len=8, ring=True)
    with pytest.raises(ValueError, match="ladder top"):
        ServeEngine(model, params, max_slots=2, cache_len=8, ladder=(1, 4))


def test_continuous_serving_matches_reference_under_the_same_load():
    """The same open-loop arrivals (numpy seed) through both launchers: the
    rung trace, the bookkeeping and the steady-state probe agree; the
    probe's rung change is a hit with no new build."""
    kw = dict(smoke=True, max_slots=4, prompt_len=3, gen_len=4, load_steps=24,
              arrival_rate=0.5, burst_every=10, burst_size=3, seed=0)
    want = jrun_continuous(ARCH, **kw)
    tcfg = get_smoke_config(ARCH)
    params = params_from_jax(
        jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(0))), tcfg)
    got = run_continuous_serving(ARCH, params=params, **kw)
    assert got["rung_trace"] == want["rung_trace"]
    assert got["requests_completed"] == want["requests_completed"]
    for k in BOOKKEEPING:
        assert got["engine"][k] == want["engine"][k], k
    assert got["probe"]["steady_state_transition_hit"]
    assert got["probe"] == want["probe"]
    assert set(got) == set(want) | {"load"}


def test_continuous_serving_load_window_leaves_out_the_probe():
    """`load` counts only the requests and tokens served in the timed load
    window: the probe's requests, served after the clock stopped, make up
    the difference to the reference's keys, gen_len tokens each."""
    gen_len = 4
    params = build_model(get_smoke_config(ARCH)).init(0, "cpu")
    got = run_continuous_serving(ARCH, params=params, max_slots=4, prompt_len=3,
                                 gen_len=gen_len, load_steps=24, arrival_rate=0.5,
                                 burst_every=10, burst_size=3, seed=0)
    load, wall_s = got["load"], got["wall_s"]
    probe_requests = got["requests_completed"] - load["requests_completed"]
    assert probe_requests >= 1 and load["requests_completed"] >= 1
    assert load["req_per_s"] == pytest.approx(load["requests_completed"] / wall_s)
    assert got["sustained_req_per_s"] == pytest.approx(
        got["requests_completed"] / wall_s)
    load_tokens = round(load["decode_tok_per_s"] * wall_s)
    assert got["engine"]["tokens_generated"] - load_tokens == probe_requests * gen_len
    assert load["p50_latency_s"] <= load["p99_latency_s"]
