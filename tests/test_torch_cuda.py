"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA card and skips without one; this
file imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: the AdamW kernels are built with -fmad=false and round where
the plain version does, so p, m and v agree to rounding of the last bit
(rtol 1e-6); a bf16 p to one bf16 rounding (rtol 2^-8); every sum (Σg²,
Σ(x−y)², Σy²) is taken in another order (rtol 1e-5)."""

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_adamw import (
    adamw_scalars, fused_adamw, fused_adamw_stats)
from repro_torch.kernels.fused_stats import fused_stats
from repro_torch.kernels.sqdiff_norm import sqdiff_norm

SIZES = [1, 17, 1_000_003]
DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1_000_003])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 0.3])
def test_cuda_kernel_matches_plain_version(cuda, n, p_dtype, clip):
    gen = torch.Generator(device=cuda).manual_seed(n)
    p = torch.randn(n, device=cuda, generator=gen).to(p_dtype)
    g = torch.randn(n, device=cuda, generator=gen)
    m = torch.randn(n, device=cuda, generator=gen)
    v = torch.rand(n, device=cuda, generator=gen)
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    sc = dict(lr=torch.tensor(1e-3, device=cuda), c1=torch.tensor(0.19, device=cuda),
              c2=torch.tensor(0.0975, device=cuda), clip_scale=torch.tensor(clip, device=cuda))
    want = ref.adamw_stats_ref(p, g, m, v, **sc, **hyper)
    gsq = fused_adamw_stats(p, g, m, v, adamw_scalars(*sc.values(), cuda), **hyper)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-6, atol=1e-9) if p_dtype == torch.float32
           else dict(rtol=2 ** -8, atol=1e-9))
    torch.testing.assert_close(p, want[0], **tol)
    torch.testing.assert_close(m, want[1], rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(v, want[2], rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(gsq, want[3], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("x_dtype,y_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_stats_kernels_match_plain_version(cuda, n, x_dtype, y_dtype, offset):
    """fused_stats and sqdiff_norm; offset 1 starts both operands one
    element into a buffer (the scalar path, as an unaligned shard view)."""
    gen = torch.Generator(device=cuda).manual_seed(n + offset)
    x = torch.randn(n + offset, device=cuda, generator=gen).to(x_dtype)[offset:]
    y = torch.randn(n + offset, device=cuda, generator=gen).to(y_dtype)[offset:]
    d, q = fused_stats(x, y)
    sq = sqdiff_norm(x, y)
    torch.cuda.synchronize()
    want = ref.fused_stats_ref(x, y)
    torch.testing.assert_close(d, want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(q, want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(sq, ref.sqdiff_norm_ref(x, y), rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPE_PAIRS)
def test_cuda_fused_adamw_matches_plain_version(cuda, n, p_dtype, g_dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    p = torch.randn(n, device=cuda, generator=gen).to(p_dtype)
    g = torch.randn(n, device=cuda, generator=gen).to(g_dtype)
    m = torch.randn(n, device=cuda, generator=gen)
    v = torch.rand(n, device=cuda, generator=gen)
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    sc = dict(lr=torch.tensor(1e-3, device=cuda), c1=torch.tensor(0.19, device=cuda),
              c2=torch.tensor(0.0975, device=cuda))
    want = ref.adamw_ref(p, g, m, v, **sc, **hyper)
    # the clip entry of the scalars is not read
    out = fused_adamw(p, g, m, v, adamw_scalars(*sc.values(), 0.5, cuda), **hyper)
    torch.cuda.synchronize()
    assert out[0] is p and out[1] is m and out[2] is v
    tol = (dict(rtol=1e-6, atol=1e-9) if p_dtype == torch.float32
           else dict(rtol=2 ** -8, atol=1e-9))
    torch.testing.assert_close(p, want[0], **tol)
    torch.testing.assert_close(m, want[1], rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(v, want[2], rtol=1e-6, atol=1e-9)
