"""Port kernels: every plain version in `repro_torch.kernels.ref` against
`repro.kernels.ref` over the sweeps of tests/test_kernels.py, and the CPU
routes of the device-dispatched `ops` entry points (`adamw_flat`,
`stats_flat`, `sqdiff_norm_tree`, `fused_adamw_tree`, `rmsnorm`,
`flash_attention`) against the Pallas kernels in interpret mode, as the
reference's own tests run them.  The CUDA kernels' own tests are in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import np32, rng, to_jax, to_torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.buckets import GRID, plan
from repro_torch.tree import tree_leaves
from repro_torch.kernels.fused_adamw import (
    adamw_scalars, fused_adamw, fused_adamw_stats)
from repro_torch.kernels.dense import dense_mm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_stats import fused_stats
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.sqdiff_norm import sqdiff_norm

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
TORCH_DT = {name: tdt for name, _, tdt in DTYPES}
# f32: same arithmetic, sums in another order; bf16 outputs may differ by
# one rounding of the final cast
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ADAMW_KW = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                c1=0.7, c2=0.4)


def _pair(shape, seed, dt_name):
    _, jdt, tdt = next(d for d in DTYPES if d[0] == dt_name)
    x = rng(seed).standard_normal(shape).astype(np.float32)
    return to_jax(x, jdt), to_torch(x, tdt)


@pytest.mark.parametrize("shape", [(17,), (1024,), (257, 3), (8, 128),
                                   (1000, 33), (2, 3, 5, 7)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_reductions_match_reference(shape, dt):
    xj, xt = _pair(shape, 1, dt)
    yj, yt = _pair(shape, 2, dt)
    for got, want in ((ref.sqdiff_norm_ref(xt, yt), jref.sqdiff_norm_ref(xj, yj)),
                      (ref.sqnorm_ref(xt), jref.sqnorm_ref(xj))):
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5)
    for got, want in zip(ref.fused_stats_ref(xt, yt), jref.fused_stats_ref(xj, yj)):
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(100,), (1024,), (31, 67)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.37])
def test_adamw_refs_match_reference(shape, dt, clip):
    pj, pt = _pair(shape, 3, dt)
    gj, gt = _pair(shape, 4, dt)
    m = rng(5).standard_normal(shape).astype(np.float32)
    v = np.abs(rng(6).standard_normal(shape)).astype(np.float32)
    got = ref.adamw_ref(pt, gt, to_torch(m), to_torch(v), **ADAMW_KW)
    want = jref.adamw_ref(pj, gj, to_jax(m), to_jax(v), **ADAMW_KW)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np32(a), np32(b), **TOL[dt])
    got = ref.adamw_stats_ref(pt, gt, to_torch(m), to_torch(v),
                              clip_scale=clip, **ADAMW_KW)
    want = jref.adamw_stats_ref(pj, gj, to_jax(m), to_jax(v),
                                clip_scale=clip, **ADAMW_KW)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np32(a), np32(b), **TOL[dt])


@pytest.mark.parametrize("rows,d", [(1, 128), (37, 256), (200, 512)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_reference(rows, d, dt):
    xj, xt = _pair((rows, d), 7, dt)
    sj, st = _pair((d,), 8, dt)
    np.testing.assert_allclose(np32(ref.rmsnorm_ref(xt, st)),
                               np32(jref.rmsnorm_ref(xj, sj)), **TOL[dt])


@pytest.mark.parametrize("b,t,h,kvh,d,causal,window,softcap", [
    (2, 256, 4, 2, 64, True, 0, 0.0),
    (1, 512, 4, 4, 64, True, 128, 0.0),
    (2, 256, 8, 2, 32, True, 0, 50.0),       # gemma2-style softcap
    (1, 256, 2, 2, 64, False, 0, 0.0),        # encoder (bidirectional)
    (1, 384, 4, 1, 64, True, 256, 30.0),      # MQA + window + cap
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_ref_matches_reference(b, t, h, kvh, d, causal, window,
                                         softcap, dt):
    """The flash-attention sweep of tests/test_kernels.py; kv heads are
    expanded (`jnp.repeat` / `repeat_interleave`) before the plain version,
    as there."""
    qj, qt = _pair((b, t, h, d), 9, dt)
    kj, kt = _pair((b, t, kvh, d), 10, dt)
    vj, vt = _pair((b, t, kvh, d), 11, dt)
    kj, vj = (jnp.repeat(x, h // kvh, axis=2) for x in (kj, vj))
    kt, vt = (torch.repeat_interleave(x, h // kvh, dim=2) for x in (kt, vt))
    kw = dict(causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(np32(ref.attention_ref(qt, kt, vt, **kw)),
                               np32(jref.attention_ref(qj, kj, vj, **kw)),
                               **TOL[dt])


@pytest.mark.parametrize("n", [1000, 70_001])
@pytest.mark.parametrize("clip", [1.0, 0.25])
def test_adamw_flat_cpu_matches_pallas_interpret(n, clip):
    """The CPU dispatch (plain version, in place) against the Pallas kernel
    run in interpret mode, as the reference's own tests run it."""
    r = rng(n)
    p, g, m = (r.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(r.standard_normal(n)).astype(np.float32)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              c1=0.19, c2=0.0975, clip_scale=clip)
    want = jops.fused_adamw_stats(to_jax(p), to_jax(g), to_jax(m), to_jax(v),
                                  interpret=True, **kw)
    pt, gt, mt, vt = (to_torch(a) for a in (p, g, m, v))
    got = ops.adamw_flat(pt, gt, mt, vt, **kw)
    assert got[0] is pt and got[1] is mt and got[2] is vt    # in place
    for a, b in zip(got, want):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-7)


def test_dispatch_is_by_device_and_kernel_wrapper_refuses_cpu():
    info = ops.flat_dispatch_info("cpu")
    assert info["flat_tail"] == info["stats_flat"] == "torch-reference"
    info = ops.flat_dispatch_info("cuda:0")
    assert info["flat_tail"] == "cuda-kernel fused_adamw_stats"
    assert info["stats_flat"] == "cuda-kernel fused_stats"
    x = torch.zeros(8)
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    for kernel in (fused_adamw_stats, fused_adamw):
        with pytest.raises(ValueError, match="CUDA device"):
            kernel(x, x, x, x, torch.zeros(4), **hyper)
    for kernel in (fused_stats, sqdiff_norm):
        with pytest.raises(ValueError, match="CUDA device"):
            kernel(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm(x, x)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(*(torch.zeros(1, 4, 2, 32) for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA device"):
        dense_mm(torch.zeros(4, 3), torch.zeros(3, 5))
    assert ops.launch_counts() == {"fused_adamw_stats": 0, "fused_adamw": 0,
                                   "fused_stats": 0, "sqdiff_norm": 0,
                                   "rmsnorm": 0, "flash_attention": 0, "dense": 0}
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.adamw_flat(meta, meta, meta, meta, lr=1e-3, beta1=0.9, beta2=0.95,
                       eps=1e-8, weight_decay=0.1, c1=0.1, c2=0.05)
    for fn in (ops.stats_flat, ops.sqdiff_norm):
        with pytest.raises(ValueError, match="no implementation"):
            fn(meta, meta)


@pytest.mark.parametrize("rows,d", [(1, 128), (37, 256), (200, 512)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_cpu_matches_pallas_interpret(rows, d, dt):
    """The CPU dispatch of `ops.rmsnorm` against the Pallas kernel, over
    tests/test_kernels.py's sweep; the port's kernel accepts any d, so a
    d that is not a multiple of 128 is checked against the plain
    reference too."""
    xj, xt = _pair((rows, d), 7, dt)
    sj, st = _pair((d,), 8, dt)
    got = ops.rmsnorm(xt, st)
    assert got.dtype == TORCH_DT[dt] and got.shape == xt.shape
    np.testing.assert_allclose(np32(got),
                               np32(jops.rmsnorm(xj, sj, interpret=True)),
                               **TOL[dt])
    xj, xt = _pair((rows, d + 3), 7, dt)
    sj, st = _pair((d + 3,), 8, dt)
    np.testing.assert_allclose(np32(ops.rmsnorm(xt, st)),
                               np32(jref.rmsnorm_ref(xj, sj)), **TOL[dt])


@pytest.mark.parametrize("b,t,h,kvh,d,causal,window,softcap", [
    (2, 256, 4, 2, 64, True, 0, 0.0),
    (1, 512, 4, 4, 64, True, 128, 0.0),
    (2, 256, 8, 2, 32, True, 0, 50.0),       # gemma2-style softcap
    (1, 256, 2, 2, 64, False, 0, 0.0),        # encoder (bidirectional)
    (1, 384, 4, 1, 64, True, 256, 30.0),      # MQA + window + cap
    (1, 256, 4, 4, 100, True, 0, 0.0),        # openllama-3b's head dim
    (2, 256, 4, 2, 100, True, 128, 0.0),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_cpu_matches_pallas_interpret(b, t, h, kvh, d, causal,
                                                      window, softcap, dt):
    """The CPU dispatch of `ops.flash_attention` (GQA expanded in
    `repeat_interleave` order, then the plain attention) against the
    Pallas kernel with the kv heads unexpanded, over tests/test_kernels.py's
    sweep and the head dim 100 of openllama-3b, which the CUDA kernel also
    takes."""
    qj, qt = _pair((b, t, h, d), 9, dt)
    kj, kt = _pair((b, t, kvh, d), 10, dt)
    vj, vt = _pair((b, t, kvh, d), 11, dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(qt, kt, vt, **kw)
    want = jops.flash_attention(qj, kj, vj, block_q=128, block_kv=128,
                                interpret=True, **kw)
    assert got.dtype == TORCH_DT[dt] and got.shape == qt.shape
    np.testing.assert_allclose(np32(got), np32(want), **TOL[dt])


def test_forward_only_kernels_refuse_grad_and_cpu_ops_differentiate():
    """The CUDA wrappers have no backward: a tensor that requires grad
    under grad mode raises before any device check; the CPU dispatch is
    the plain version and differentiates."""
    x = torch.ones(3, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rmsnorm(x, torch.ones(8))
    q = torch.zeros(1, 4, 2, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q.detach(), q.detach())
    ops.rmsnorm(x, torch.ones(8)).sum().backward()
    assert x.grad is not None
    ops.flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None
    with pytest.raises(ValueError, match="no implementation"):
        ops.rmsnorm(torch.zeros(2, 8, device="meta"), torch.zeros(8))


SWEEP = [(17,), (1024,), (257, 3), (8, 128), (1000, 33), (2, 3, 5, 7)]


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dts", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                 ("bfloat16", "float32")])
def test_stats_flat_cpu_matches_pallas_interpret(shape, dts):
    """(Σ(x−y)², Σy²) of the CPU dispatch against the Pallas `fused_stats`,
    f32, bf16 and mixed operands; both sum in f32, in another order."""
    xj, xt = _pair(shape, 12, dts[0])
    yj, yt = _pair(shape, 13, dts[1])
    got = ops.stats_flat(xt, yt)
    want = jops.fused_stats(xj, yj, interpret=True)
    assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sqdiff_norm_tree_cpu_matches_pallas_interpret(dt):
    """Σ‖a−b‖² over a tree holding every shape of the sweep."""
    pairs = [_pair(shape, 20 + i, dt) for i, shape in enumerate(SWEEP)]
    others = [_pair(shape, 40 + i, dt) for i, shape in enumerate(SWEEP)]
    tree = lambda xs: {"a": xs[0], "b": list(xs[1:4]), "c": {"d": xs[4], "e": xs[5]}}
    got = ops.sqdiff_norm_tree(tree([t for _, t in pairs]),
                               tree([t for _, t in others]))
    want = jops.sqdiff_norm_tree(tree([j for j, _ in pairs]),
                                 tree([j for j, _ in others]), interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5)
    x, y = pairs[0][1], others[0][1]
    np.testing.assert_allclose(np32(ops.sqdiff_norm(x, y)),
                               np32(jops.sqdiff_norm(pairs[0][0], others[0][0],
                                                     interpret=True)), rtol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_adamw_tree_cpu_matches_pallas_interpret(dt):
    """The per-tensor AdamW over a tree of the sweep's shapes, in place,
    against the Pallas `fused_adamw` leaf by leaf."""
    shapes = [(100,), (1024,), (31, 67)]
    ps = [_pair(s, 50 + i, dt) for i, s in enumerate(shapes)]
    gs = [_pair(s, 60 + i, dt) for i, s in enumerate(shapes)]
    ms = [rng(70 + i).standard_normal(s).astype(np.float32)
          for i, s in enumerate(shapes)]
    vs = [np.abs(rng(80 + i).standard_normal(s)).astype(np.float32)
          for i, s in enumerate(shapes)]
    tree = lambda xs: {"w": xs[0], "blocks": [xs[1], xs[2]]}
    want = jops.fused_adamw_tree(
        tree([j for j, _ in ps]), tree([j for j, _ in gs]),
        tree([to_jax(m) for m in ms]), tree([to_jax(v) for v in vs]),
        interpret=True, **ADAMW_KW)
    p_t = tree([t for _, t in ps])
    m_t, v_t = tree([to_torch(m) for m in ms]), tree([to_torch(v) for v in vs])
    got = ops.fused_adamw_tree(p_t, tree([t for _, t in gs]), m_t, v_t,
                               **ADAMW_KW)
    assert got[0]["w"] is p_t["w"] and got[1]["blocks"][1] is m_t["blocks"][1]
    assert {x.dtype for x in tree_leaves(got[0])} == {TORCH_DT[dt]}
    for g_tree, w_tree in zip(got, want):
        for a, b in zip(tree_leaves(g_tree), jax.tree.leaves(w_tree)):
            np.testing.assert_allclose(np32(a), np32(b), **TOL[dt])


def test_grid_and_scalars():
    """A one-bucket launch: ceil(n / 4096) tiles on min(GRID, tiles) blocks,
    one partial a block."""
    sizes = (0, 1, 4096, 4097, 1 << 20, 32_768_000)
    launches = [plan([(n, ((0, 4, "float32"),))]) for n in sizes]
    assert [g[0].tiles for g, _ in launches] == [0, 1, 1, 2, 256, 8000]
    assert [g[0].grid for g, _ in launches] == [0, 1, 1, 2, 256, GRID] == \
        [count for _, count in launches]
    s = adamw_scalars(torch.tensor(1e-3), 0.1, torch.tensor(0.05), 1.0, "cpu")
    assert s.dtype == torch.float32 and s.shape == (4,)
    np.testing.assert_array_equal(s.numpy(), np.float32([1e-3, 0.1, 0.05, 1.0]))


def test_tree_routes_mixed_tiny_and_empty_leaves_match_pallas_interpret():
    """Both tree routes over one tree of 40 tiny leaves, an empty one and a
    larger one, f32 and bf16 mixed, against the reference's tree routes
    (Pallas in interpret mode); and the table the card would launch: one
    row a leaf pair, two dtype groups, the empty leaf without a tile."""
    shapes = [(1 + i % 5,) for i in range(40)] + [(0,), (37, 129)]
    dts = ["float32" if i % 3 else "bfloat16" for i in range(len(shapes))]
    xs = [_pair(s, 100 + i, dt) for i, (s, dt) in enumerate(zip(shapes, dts))]
    ys = [_pair(s, 200 + i, dt) for i, (s, dt) in enumerate(zip(shapes, dts))]
    got = ops.sqdiff_norm_tree([t for _, t in xs], [t for _, t in ys])
    want = jops.sqdiff_norm_tree([j for j, _ in xs], [j for j, _ in ys],
                                 interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5)
    groups, partials = plan([(t.numel(), ((0, t.element_size(), str(t.dtype)[6:]),
                                          (0, u.element_size(), str(u.dtype)[6:])))
                             for (_, t), (_, u) in zip(xs, ys)])
    assert [len(g.rows) for g in groups] == [dts.count("bfloat16"), dts.count("float32")]
    assert sum(g.tiles for g in groups) == 40 + 0 + 2     # (37, 129): 2 tiles
    ms = [rng(300 + i).standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)]
    vs = [np.abs(rng(400 + i).standard_normal(s)).astype(np.float32)
          for i, s in enumerate(shapes)]
    want = jops.fused_adamw_tree([j for j, _ in xs], [j for j, _ in ys],
                                 [to_jax(m) for m in ms], [to_jax(v) for v in vs],
                                 interpret=True, **ADAMW_KW)
    p_t, m_t = [t for _, t in xs], [to_torch(m) for m in ms]
    got = ops.fused_adamw_tree(p_t, [t for _, t in ys], m_t,
                               [to_torch(v) for v in vs], **ADAMW_KW)
    assert got[0] is p_t and got[1] is m_t
    for g_list, w_list in zip(got, want):
        for a, b, dt in zip(g_list, w_list, dts):
            np.testing.assert_allclose(np32(a), np32(b), **TOL[dt])


def test_adamw_scalars_keep_device_values_and_take_host_ones():
    """The step's scalars: host floats and CPU tensors, as f32, in order;
    on the CPU no copy is needed (the card's pinned upload is tested in
    test_torch_cuda.py)."""
    lr = torch.tensor(3e-4, dtype=torch.float64)
    s = adamw_scalars(lr, torch.tensor(0.19), 0.0975, torch.tensor(0.5), "cpu")
    np.testing.assert_array_equal(
        s.numpy(), np.float32([np.float32(3e-4), 0.19, 0.0975, 0.5]))
