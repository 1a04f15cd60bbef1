"""Port kernels: every plain version in `repro_torch.kernels.ref` against
`repro.kernels.ref` over the sweeps of tests/test_kernels.py, the
device-dispatched `ops.adamw_flat` against the Pallas `fused_adamw_stats`
(interpret mode).  The CUDA kernel's own tests are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_helpers import np32, rng, to_jax, to_torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_adamw import (
    adamw_scalars, fused_adamw_stats, grid_for)

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
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
    assert ops.flat_dispatch_info("cpu")["flat_tail"] == "torch-reference"
    assert ops.flat_dispatch_info("cuda:0")["flat_tail"].startswith("cuda-kernel")
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_adamw_stats(x, x, x, x, torch.zeros(4), beta1=0.9, beta2=0.95,
                          eps=1e-8, weight_decay=0.1)
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.adamw_flat(meta, meta, meta, meta, lr=1e-3, beta1=0.9, beta2=0.95,
                       eps=1e-8, weight_decay=0.1, c1=0.1, c2=0.05)


def test_grid_and_scalars():
    assert [grid_for(n) for n in (0, 1, 4096, 4097, 1 << 20, 32_768_000)] == \
        [1, 1, 1, 2, 256, 2048]
    s = adamw_scalars(torch.tensor(1e-3), 0.1, torch.tensor(0.05), 1.0, "cpu")
    assert s.dtype == torch.float32 and s.shape == (4,)
    np.testing.assert_array_equal(s.numpy(), np.float32([1e-3, 0.1, 0.05, 1.0]))
