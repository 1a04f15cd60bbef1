"""The multi-bucket launch of the flat training tail, on the CPU.

* The bucket table (`repro_torch.kernels.buckets.plan`): tiles, their
  prefix, the alignment flags and the dtype groups, on hand-made lists and
  on microllama-300m's smoke layout at J = 1 and 2 (the worker's shard
  views).  Exact.
* `ops.adamw_flat_buckets` and `ops.stats_flat_buckets` on the CPU against
  the reference's per-bucket `fused_adamw_stats` and `fused_stats` (Pallas
  in interpret mode, as the reference's own tests run them) over a smoke
  layout with ragged buckets and f32 and bf16 params: ≤ 1e-5 relative in
  f32, one bf16 rounding for a bf16 p (the frameworks round the same f32
  value); and bit for bit against the port's own per-bucket `adamw_flat`
  and `stats_flat`, whose plain arithmetic and bucket-order sums they share.
* The step builders' device default: with neither `params_like` nor
  `device` they build on the CUDA card, and raise without one.

The CUDA kernels behind the list calls are tested on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np32, rng, to_jax, to_torch

from repro.kernels import ops as jops
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.flatbuf import FlatLayout
from repro_torch.distributed.sharding import shard_bucket
from repro_torch.distributed.train_step import (
    make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.kernels import ops
from repro_torch.kernels.buckets import GRID, OPERANDS, ROW, TILE, TableCache, plan
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_map

ARCH = "microllama-300m"
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
             c1=0.19, c2=0.0975)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-7),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-7)}


def _f32(addr, n):
    """One bucket of two f32 operands at `addr` and `addr + 4096`."""
    return n, ((addr, 4, "float32"), (addr + 4096, 4, "float32"))


def test_plan_tiles_prefix_alignment_and_groups():
    bf = lambda addr: (addr, 2, "bfloat16")
    entries = [
        _f32(1 << 20, 1),                       # one tile, one element
        _f32(1 << 24, 4096),                    # exactly one tile
        (4097, ((1 << 26, 4, "float32"), bf(1 << 27))),    # a bf16 group
        _f32((1 << 28) + 4, 17),                # unaligned by 4 bytes: scalar
        _f32(1 << 29, 0),                       # empty: no tile
        (8193, ((1 << 30, 4, "float32"), bf((1 << 31) + 8))),  # bf16 at 8 B: vector
        _f32(1 << 32, 5_767_168),
    ]
    groups, partials = plan(entries)
    assert [g.dtypes for g in groups] == [("float32", "float32"),
                                          ("float32", "bfloat16")]
    f32, mixed = groups
    assert [r[OPERANDS] for r in f32.rows] == [1, 4096, 17, 0, 5_767_168]
    assert [r[OPERANDS] for r in mixed.rows] == [4097, 8193]
    # first tile: the prefix of ceil(n / TILE) within the group
    assert [r[OPERANDS + 1] for r in f32.rows] == [0, 1, 2, 3, 3]
    assert f32.tiles == 3 + 5_767_168 // TILE
    assert [r[OPERANDS + 1] for r in mixed.rows] == [0, 2] and mixed.tiles == 5
    assert [r[OPERANDS + 2] for r in f32.rows] == [1, 1, 0, 1, 1]
    assert [r[OPERANDS + 2] for r in mixed.rows] == [1, 1]
    assert f32.rows[2][:OPERANDS] == ((1 << 28) + 4, (1 << 28) + 4100, 0, 0)
    assert all(len(r) == ROW for g in groups for r in g.rows)
    assert (f32.grid, mixed.grid) == (GRID, 5)
    assert (f32.first_row, mixed.first_row) == (0, 5)
    assert (f32.first_partial, mixed.first_partial) == (0, GRID)
    assert partials == GRID + 5
    with pytest.raises(ValueError, match="operands"):
        plan([(4, ((0, 4, "float32"),) * (OPERANDS + 1))])


@pytest.mark.parametrize("J", [1, 2])
def test_plan_on_the_smoke_layout(J):
    """The table of the AdamW tail over microllama's smoke layout: one f32
    group, every bucket's tiles in order, and on the shard views of J = 2
    the alignment each view's address gives."""
    params = build_model(get_smoke_config(ARCH)).init(0, "cpu")
    layout = FlatLayout.from_tree(params, shard_divisor=J)
    full = layout.zeros(torch.float32)
    # a view one element in: the shard of an odd-sized bucket is unaligned
    odd = torch.zeros(2 * 4097 + 1)[1:]
    bufs = [shard_bucket(b, J - 1, J) for b in full] + [shard_bucket(odd, J - 1, J)]
    entries = [(b.numel(), tuple((b.data_ptr(), 4, "float32") for _ in range(4)))
               for b in bufs]
    (group,), partials = plan(entries)
    sizes = [n // J for n in layout.buffer_sizes] + [odd.numel() // J]
    tiles = [-(-n // TILE) for n in sizes]
    assert [r[OPERANDS] for r in group.rows] == sizes
    assert [r[OPERANDS + 1] for r in group.rows] == list(np.cumsum([0] + tiles[:-1]))
    assert group.tiles == sum(tiles) and group.grid == partials == min(GRID, sum(tiles))
    aligned = [int(b.data_ptr() % 16 == 0) for b in bufs]
    assert [r[OPERANDS + 2] for r in group.rows] == aligned
    assert aligned[:-1] == [1] * layout.num_buffers and aligned[-1] == 0


def test_table_cache_hits_rebuilds_and_evicts():
    cache = TableCache(capacity=2)
    entries = [_f32(1 << 20, 5000), _f32(1 << 24, 3)]
    groups, partials, table = cache.get(("a",), entries, "cpu")
    assert cache.builds == 1 and cache.hits == 0
    assert table.dtype == torch.int64
    assert table.tolist() == [x for row in groups[0].rows for x in row]
    assert cache.get(("a",), entries, "cpu")[2] is table and cache.hits == 1
    cache.get(("b",), entries[:1], "cpu")
    cache.get(("c",), entries[1:], "cpu")        # evicts ("a",)
    assert cache.get(("a",), entries, "cpu")[2] is not table
    assert cache.builds == 4 and cache.hits == 1


def _tail_inputs(seed):
    """A smoke layout with bf16 and f32 params (the embedding and final norm
    bf16) and ragged buckets (three leaves of odd sizes added), packed p,
    and random f32 g, m, v."""
    params = build_model(get_smoke_config(ARCH)).init(0, "cpu")
    params = dict(params, embed=tree_map(lambda x: x.to(torch.bfloat16), params["embed"]),
                  final_norm=tree_map(lambda x: x.to(torch.bfloat16),
                                      params["final_norm"]),
                  ragged=[torch.ones(17), torch.ones(4099), torch.ones(3, 5)])
    layout = FlatLayout.from_tree(params, bucket_bytes=24 << 10)
    pb = layout.flatten(params)
    r = rng(seed)
    draw = lambda n, scale: (scale * r.standard_normal(n)).astype(np.float32)
    gb = [draw(p.numel(), 1e-3) for p in pb]
    mb = [draw(p.numel(), 1e-4) for p in pb]
    vb = [np.abs(draw(p.numel(), 1e-6)) for p in pb]
    return layout, pb, gb, mb, vb


def test_tail_layout_is_ragged_and_mixed():
    layout, pb, *_ = _tail_inputs(0)
    assert {p.dtype for p in pb} == {torch.float32, torch.bfloat16}
    assert any(n % TILE for n in layout.buffer_sizes)
    assert any(n % 4 for n in layout.buffer_sizes)


@pytest.mark.parametrize("clip", [1.0, 0.37])
def test_adamw_flat_buckets_cpu_matches_reference(clip):
    layout, pb, gb, mb, vb = _tail_inputs(1)
    kw = dict(HYPER, clip_scale=clip)
    want = [jops.fused_adamw_stats(to_jax(np32(p), jnp.bfloat16 if p.dtype == torch.bfloat16
                                          else jnp.float32),
                                   to_jax(g), to_jax(m), to_jax(v), interpret=True, **kw)
            for p, g, m, v in zip(pb, gb, mb, vb)]
    # the port's own per-bucket loop, on copies
    loop = [ops.adamw_flat(p.clone(), to_torch(g), to_torch(m), to_torch(v), **kw)
            for p, g, m, v in zip(pb, gb, mb, vb)]
    loop_gsq = torch.zeros(())
    for out in loop:
        loop_gsq = loop_gsq + out[3]
    mt, vt = [to_torch(m) for m in mb], [to_torch(v) for v in vb]
    gsq = ops.adamw_flat_buckets(pb, [to_torch(g) for g in gb], mt, vt, **kw)
    assert gsq.dtype == torch.float32 and gsq.shape == ()
    assert torch.equal(gsq, loop_gsq)
    for i, (p, m, v) in enumerate(zip(pb, mt, vt)):
        for got, ported, ref in zip((p, m, v), loop[i][:3], want[i][:3]):
            assert torch.equal(got, ported)
            np.testing.assert_allclose(np32(got), np32(ref), **TOL[got.dtype])
    np.testing.assert_allclose(np32(gsq), sum(float(np32(w[3])) for w in want),
                               rtol=1e-5)


@pytest.mark.parametrize("J", [1, 2])
def test_stats_flat_buckets_cpu_matches_reference(J):
    """(Σ(x−y)², Σy²) over every bucket, on the worker's shard views at
    J = 2 as on the full buckets, bf16 and f32 operands."""
    layout, pb, gb, *_ = _tail_inputs(2)
    xs = [shard_bucket(to_torch(g), J - 1, J) if p.dtype == torch.float32
          else shard_bucket(to_torch(g).to(torch.bfloat16), J - 1, J)
          for p, g in zip(pb, gb)]
    ys = [shard_bucket(p, J - 1, J) for p in pb]
    dsq, ysq = ops.stats_flat_buckets(xs, ys)
    loop = [ops.stats_flat(x, y) for x, y in zip(xs, ys)]
    want_d, want_y = torch.zeros(()), torch.zeros(())
    for d, q in loop:
        want_d, want_y = want_d + d, want_y + q
    assert torch.equal(dsq, want_d) and torch.equal(ysq, want_y)
    jdt = lambda t: jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    ref = [jops.fused_stats(to_jax(np32(x), jdt(x)), to_jax(np32(y), jdt(y)),
                            interpret=True) for x, y in zip(xs, ys)]
    for got, k in ((dsq, 0), (ysq, 1)):
        np.testing.assert_allclose(np32(got), sum(float(np32(r[k])) for r in ref),
                                   rtol=1e-5)


@pytest.mark.parametrize("make", [make_accum_norm_step, make_fsdp_norm_step])
def test_step_builders_default_to_the_card(make, monkeypatch):
    model = build_model(get_smoke_config(ARCH))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(model, AdamWConfig(), stats_impl="flat", params_impl="flat")
    with pytest.raises(ValueError):       # the impl check still comes first
        make(model, AdamWConfig(), stats_impl="x", params_impl="x")
    wrap = make(model, AdamWConfig(), stats_impl="flat", params_impl="flat",
                device="cpu")
    assert wrap.flat_layout.num_buffers > 1
