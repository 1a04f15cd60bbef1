"""The span recorder (`repro_torch.tracing`) inside the training step, on
the CPU.

* Off: `span` is one shared no-op, nothing is recorded, and one smoke
  ACCUM-NORM step dispatches the same operations with tracing on as off.
* On, ACCUM-NORM flat/flat at M = 2: one `step` holding two forward /
  backward / accumulate spans, one statistic, one tail and one metrics
  span, every span nested in its parent's interval and carrying step 0.
* On, FSDP-Norm flat/flat over 2 gloo ranks with `remat="full"`: the
  recomputed `model.block` spans lie inside `step.backward`, and the
  `comm.*` spans carry the flat buffers' bytes and the group's size.
* The tensor-parallel collectives: `comm.*` spans over the model group,
  and `TP_STATS["seconds"]` added only where the backend blocks the host.
"""

import collections
import dataclasses
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, TP_STATS, shard_flat_buffers, use_sharding_rules)
from repro_torch.distributed.train_step import (
    batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat
from repro_torch.tree import tree_flatten, tree_unflatten

ARCH = "llama3.2-1b"
PLAN = BatchPlan(global_batch=4, micro_batch=2, accum_steps=2, workers=1)
TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def _accum_step(cfg=None):
    """A fresh smoke ACCUM-NORM flat/flat step, its state and one batch."""
    cfg = cfg or get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    wrap = make_accum_norm_step(model, AdamWConfig(), stats_impl="flat",
                                params_impl="flat", params_like=params,
                                device="cpu")
    layout = wrap.flat_layout
    batch = make_batch(MarkovTokens(vocab_size=cfg.vocab_size, seed=0), 0, PLAN, 16)
    return (wrap(batch), tuple(layout.flatten(params)),
            init_adamw_flat(params, layout=layout), batch_to_device(batch, "cpu"))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_off_is_one_shared_noop_and_records_nothing():
    assert tracing.span("step") is tracing.OFF
    assert tracing.span("comm.all_reduce", bytes=4, group=2) is tracing.OFF
    tracing.enable()
    tracing.disable()
    step, params, opt, batch = _accum_step()
    step(params, opt, batch, 1e-3)
    assert tracing.collect() == []


def test_spans_dispatch_no_operation():
    runs = {}
    for on in (False, True):
        step, params, opt, batch = _accum_step()
        if on:
            tracing.enable()
        with _Ops() as mode:
            step(params, opt, batch, 1e-3)
        tracing.disable()
        runs[on] = mode.ops
    assert runs[True] == runs[False]
    assert len(runs[True]) > 100
    assert len(tracing.collect()) > 0


def test_accum_norm_step_spans():
    cfg = get_smoke_config(ARCH)
    step, params, opt, batch = _accum_step(cfg)
    tracing.enable()
    step(params, opt, batch, 1e-3)
    tracing.disable()
    spans = tracing.collect()
    count = collections.Counter(s.name for s in spans)
    assert count == {"step": 1, "step.forward": 2, "step.backward": 2,
                     "step.accumulate": 2, "step.statistic": 1, "step.tail": 1,
                     "step.metrics": 1, "model.block": 2 * cfg.num_layers}
    root = next(s for s in spans if s.name == "step")
    by_id = {s.id: s for s in spans}
    assert root.parent is None
    for s in spans:
        assert s.step == 0 and s.thread == root.thread
        if s is not root:
            assert _within(s, by_id[s.parent])
        if s.name.startswith("step."):
            assert s.parent == root.id
        if s.name == "model.block":
            assert by_id[s.parent].name == "step.forward"
    phases = [s.name for s in spans if s.name.startswith("step.")]
    assert phases == ["step.forward", "step.backward", "step.accumulate"] * 2 + [
        "step.tail", "step.statistic", "step.metrics"]
    # a fresh record numbers its steps from 0; each step's spans share it
    tracing.enable()
    for _ in range(2):
        step(params, opt, batch, 1e-3)
    tracing.disable()
    again = tracing.collect()
    assert len(again) == 2 * len(spans)
    assert [s.step for s in again] == [0] * len(spans) + [1] * len(spans)


def _rank_fsdp():
    """Two FSDP-Norm flat/flat steps of smoke llama with every layer
    recomputed, the second traced; (its spans, the flat buffers' bytes)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), remat="full")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl="flat",
                               params_impl="flat", params_like=params)
    layout = wrap.flat_layout
    opt = init_adamw_flat(params, shard_divisor=2, layout=layout)
    flat = tuple(shard_flat_buffers(layout.flatten(params)))
    plan = BatchPlan(global_batch=4, micro_batch=1, accum_steps=2, workers=2)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    for t in range(2):
        if t == 1:
            tracing.enable()
        flat, opt, _ = wrap(None)(flat, opt, batch_to_device(
            make_batch(src, t, plan, 16), "cpu"), torch.tensor(1e-3))
    tracing.disable()
    nbytes = [n * torch.empty((), dtype=dt).element_size()
              for n, dt in zip(layout.buffer_sizes, layout.buffer_dtypes)]
    return tracing.collect(), nbytes, list(layout.buffer_sizes), cfg.num_layers


def test_fsdp_norm_spans_recompute_and_collectives():
    spans, nbytes, sizes, layers = tmesh.spawn_workers(_rank_fsdp, 2,
                                                       timeout_s=TIMEOUT_S)
    backward = [s for s in spans if s.name == "step.backward"]
    forward = [s for s in spans if s.name == "step.forward"]
    blocks = [s for s in spans if s.name == "model.block"]
    assert len(backward) == len(forward) == 2
    recomputed = [b for b in blocks if any(_within(b, s) for s in backward)]
    assert len(recomputed) == len(blocks) - len(recomputed) == 2 * layers
    assert all(any(_within(b, s) for s in forward)
               for b in blocks if b not in recomputed)
    comm = [s for s in spans if s.name.startswith("comm.")]
    assert comm and all(s.counts["group"] == 2 for s in comm)
    gather = next(s for s in spans if s.name == "step.gather_params")
    assert sorted(s.counts["bytes"] for s in comm if s.name == "comm.all_gather"
                  and _within(s, gather)) == sorted(nbytes)
    exchange = next(s for s in spans if s.name == "step.exchange")
    reduced = [s.counts["bytes"] for s in comm
               if s.name == "comm.all_reduce" and _within(s, exchange)]
    # the workers' token weight (one f32), then each f32 gradient buffer
    assert reduced == [4] + [4 * n for n in sizes]


def _rank_tp():
    """A smoke llama forward and backward on a 1 × 2 grid (tensor
    parallel), traced; (its comm spans, TP_STATS)."""
    mesh = tmesh.make_host_mesh(data=1, model=2)
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    from repro_torch.distributed import params as tparams
    params = tparams.shard_tree(model.init(0, "cpu"),
                                tparams.param_pspecs(model.init(0, "cpu"), mesh), mesh)
    leaves, treedef = tree_flatten(params)
    xs = [p.detach().contiguous().requires_grad_(True) for p in leaves]
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)}
    sharding.reset_tp_stats()
    tracing.enable()
    with use_sharding_rules(DEFAULT_RULES, mesh):
        loss = model.loss(tree_unflatten(treedef, xs), batch)[0]
        torch.autograd.grad(loss, xs)
    tracing.disable()
    return [s for s in tracing.collect() if s.name.startswith("comm.")], dict(TP_STATS)


def test_tp_collectives_spans_and_seconds_under_gloo():
    comm, stats = tmesh.spawn_workers(_rank_tp, 2, timeout_s=TIMEOUT_S)
    assert len(comm) == stats["calls"] > 0
    assert all(s.name == "comm.all_reduce" and s.counts["group"] == 2
               and s.counts["bytes"] > 0 for s in comm)
    assert stats["seconds"] > 0


@pytest.mark.parametrize("backend,timed", [("gloo", True), ("nccl", False)])
def test_tp_seconds_only_where_the_backend_blocks(monkeypatch, backend, timed):
    """Under NCCL a collective's call returns once it is enqueued: its host
    seconds are not the collective's, and are not added."""
    monkeypatch.setattr(sharding.dist, "get_backend", lambda group=None: backend)
    sharding.reset_tp_stats()
    with sharding._tp_collective("all_reduce", 8, None):
        time.sleep(0.01)
    assert TP_STATS["calls"] == 1
    assert (TP_STATS["seconds"] >= 0.01) if timed else TP_STATS["seconds"] == 0.0
    sharding.reset_tp_stats()
