"""Port control plane against the reference, exactly: plans, ladders,
schedules, the controller + GNS trajectory, and the batches."""

import dataclasses
import itertools

import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (thread cap)

from repro.core import controller as jc, gns as jg, schedule as js
from repro.data import pipeline as jd
from repro_torch.core import controller as tc, gns as tg, schedule as ts
from repro_torch.data import pipeline as td


def _same(a, b):
    """Dataclass / tuple results compare field by field across packages."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    else:
        assert a == b


PLAN_GRID = list(itertools.product([1, 3, 7, 16, 100, 257, 4096],  # desired
                                   [1, 2, 4],                        # workers
                                   [(1, 8), (2, 4), (4, 16)],        # micro, max
                                   [1, 2, 16],                       # base accum
                                   [64, 1024]))                      # max global


@pytest.mark.parametrize("micro_buckets", [True, False])
def test_round_plan_and_accum_free(micro_buckets):
    for desired, j, (mb, mmb), acc, mg in PLAN_GRID:
        args = (desired, j, mb, mmb, acc, mg)
        want = js.round_plan(*args, micro_buckets=micro_buckets)
        got = ts.round_plan(*args, micro_buckets=micro_buckets)
        _same(got, want)
        _same(ts.accum_free_plan(got), js.accum_free_plan(want))


def test_bucket_ladder_quantize_and_parse():
    for _, j, (mb, mmb), acc, mg in PLAN_GRID:
        for base in (1, 4, 32):
            want = js.bucket_ladder(j, mb, mmb, acc, base, mg)
            got = ts.bucket_ladder(j, mb, mmb, acc, base, mg)
            _same(got, want)
            for d in (1, 5, 33, 200, 5000):
                for cap in (None, 16, mg):
                    _same(ts.quantize_to_ladder(d, got, cap),
                          js.quantize_to_ladder(d, want, cap))
    spec = "1:2,2:2,2:4,4:4"
    _same(ts.parse_ladder(spec, 2), js.parse_ladder(spec, 2))
    with pytest.raises(ValueError):
        ts.parse_ladder("2:2,1:2", 1)


def test_constant_and_stagewise_schedules():
    plan = ts.round_plan(16, 1, 2, 4, 2, 16)
    assert ts.ConstantSchedule(plan).plan_for(5, 100) == plan
    stages = ((0.1, 6), (0.3, 40), (0.6, 200))
    ladder_j = js.bucket_ladder(1, 2, 8, 2, 8, 256)
    ladder_t = ts.bucket_ladder(1, 2, 8, 2, 8, 256)
    for lj, lt in ((None, None), (ladder_j, ladder_t)):
        sj = js.StagewiseSchedule(stages, 1, 2, 8, 2, ladder=lj)
        st = ts.StagewiseSchedule(stages, 1, 2, 8, 2, ladder=lt)
        for samples in range(0, 1000, 37):
            _same(st.plan_for(samples, 1000), sj.plan_for(samples, 1000))


def _stream(n, seed):
    """A recorded (var_l1, grad_sqnorm) stream with growing noise."""
    r = np.random.default_rng(seed)
    gsq = np.exp(r.normal(0, 0.3, n)) * np.linspace(1.0, 0.2, n)
    var = np.exp(r.normal(0, 0.5, n)) * np.linspace(0.5, 20.0, n)
    return list(zip(var.tolist(), gsq.tolist()))


@pytest.mark.parametrize("ema,interval,groups", [(0.0, 1, "accum"),
                                                 (0.5, 2, "workers")])
def test_controller_and_gns_trajectory(ema, interval, groups):
    kw = dict(eta=0.15, workers=2, base_micro_batch=2, max_micro_batch=8,
              base_accum=2, base_global_batch=8, max_global_batch=512,
              test_interval=interval, ema=ema, predict=True, gns_groups=groups)
    lj = js.bucket_ladder(2, 2, 8, 2, 8, 512)
    lt = ts.bucket_ladder(2, 2, 8, 2, 8, 512)
    cj, ct = jc.ControllerConfig(ladder=lj, **kw), tc.ControllerConfig(ladder=lt, **kw)
    sj, st = jc.init_controller(cj), tc.init_controller(ct)
    trk_j, trk_t = jg.GNSTracker(), tg.GNSTracker()
    for var, gsq in _stream(60, 3):
        sj = jc.controller_update(cj, sj, var, gsq)
        st = tc.controller_update(ct, st, var, gsq)
        assert tc.controller_state_as_dict(st) == jc.controller_state_as_dict(sj)
        b, g = sj.plan.global_batch, jg.variance_groups("accum_norm", 2, 4)
        trk_j = trk_j.update(var, gsq, b, 2, groups=g)
        trk_t = trk_t.update(var, gsq, b, 2, groups=g)
        assert dataclasses.asdict(trk_t) == dataclasses.asdict(trk_j)
        assert tg.unbiased_gns_pair(var, gsq, b, 2, g) == \
            jg.unbiased_gns_pair(var, gsq, b, 2, g)
        assert tg.gns_from_norm_test(var, gsq, b, 2) == \
            jg.gns_from_norm_test(var, gsq, b, 2)
    assert st.num_increases > 0
    d = tc.controller_state_as_dict(st)
    assert tc.controller_state_as_dict(tc.controller_state_from_dict(d)) == d


@pytest.mark.parametrize("source", ["markov", "uniform"])
def test_batches_are_byte_identical(source):
    mk = {"markov": (jd.MarkovTokens, td.MarkovTokens),
          "uniform": (jd.UniformTokens, td.UniformTokens)}[source]
    src_j, src_t = mk[0](vocab_size=97, seed=5), mk[1](vocab_size=97, seed=5)
    for step, (mb, m) in itertools.product([0, 3, 1_000_000_001],
                                           [(2, 1), (2, 3), (4, 2)]):
        plan = js.BatchPlan(global_batch=mb * m, micro_batch=mb,
                            accum_steps=m, workers=1)
        tplan = ts.BatchPlan(**dataclasses.asdict(plan))
        extra = {"frames": (3, 4)}
        bj = jd.make_batch(src_j, step, plan, 16, extra)
        bt = td.make_batch(src_t, step, tplan, 16, extra)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bj[k].dtype == bt[k].dtype and bj[k].tobytes() == bt[k].tobytes()
        bucket = js.BatchPlan(global_batch=4 * 4, micro_batch=4, accum_steps=4,
                              workers=1)
        pj = jd.pad_to_bucket(bj, plan, bucket)
        pt = td.pad_to_bucket(bt, tplan, ts.BatchPlan(**dataclasses.asdict(bucket)))
        for k in pj:
            assert pj[k].shape == pt[k].shape and pj[k].tobytes() == pt[k].tobytes()
        mj, mt = list(jd.microbatches(pj)), list(td.microbatches(pt))
        assert len(mj) == len(mt) == 4
        assert all(a["tokens"].tobytes() == b["tokens"].tobytes()
                   for a, b in zip(mj, mt))
