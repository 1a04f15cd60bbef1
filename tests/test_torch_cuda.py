"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA card and skips without one; this
file imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: the AdamW kernels are built with -fmad=false and round where
the plain version does, so p, m and v agree to rounding of the last bit
(rtol 1e-6); a bf16 p to one bf16 rounding (rtol 2^-8); every sum (Σg²,
Σ(x−y)², Σy²) is taken in another order (rtol 1e-5).  rmsnorm and
flash_attention sum in another order than the plain version: f32 at
rtol 1e-5 / atol 1e-5 (rmsnorm) and 2e-5 (flash, where exp, the online
rescaling and the split-TF32 products add a few ulps; at logits of 30-50
flash f32 is held to 2e-5 of the f64 attention instead, see
`test_cuda_flash_attention_large_logits`); bf16 outputs to one bf16
rounding (2^-7 relative, 1e-2 absolute).  The list entry points over many buckets are
held against the plain versions bucket by bucket at the same tolerances,
and two calls on the same inputs must give the same bits.  The dense
split-TF32 GEMM is held to the f64 product: at most twice cuBLAS's f32
error (`torch.matmul`, TF32 off) at every main-path product, and on ragged
shapes also under `DENSE_FLOOR` (a short sum: cuBLAS's error is a rounding
of the output, the kernel keeps its split's ~2^-22 a product); its
gradients against the einsum's at rtol 1e-5.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import dense as dense_mod
from repro_torch.kernels.buckets import TABLES
from repro_torch.kernels.fused_adamw import (
    adamw_scalars, fused_adamw, fused_adamw_stats, fused_adamw_stats_buckets)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_stats import fused_stats, fused_stats_buckets
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.sqdiff_norm import sqdiff_norm
from repro_torch.models.model import build_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    DENSE_FLOOR, DENSE_RAGGED, DENSE_ROWS, DENSE_SHAPES, dense_errors, dense_operands,
    forward_kernel_launches, frontend_inputs, prefill_vs_decode)

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


# bucket lists: ragged sizes, an entry one element into its buffers (the
# scalar loop) and two dtype groups (the last two entries)
BUCKETS = [(1, 0, torch.float32), (17, 0, torch.float32), (2048, 0, torch.float32),
           (1_000_003, 0, torch.float32), (5_767_168, 0, torch.float32),
           (2048, 1, torch.float32), (4099, 0, torch.bfloat16),
           (1_000_003, 0, torch.bfloat16)]


def _views(n, offset, dtype, gen, cuda, scale=1.0):
    x = scale * torch.randn(n + offset, device=cuda, generator=gen)
    return x.to(dtype)[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [1.0, 0.3])
def test_cuda_adamw_buckets_match_plain_loop(cuda, clip):
    """One list call against `ref.adamw_stats_ref` bucket by bucket: p in
    its dtype (f32 or bf16), g f32, m and v f32; Σg² over every bucket.
    One launch per dtype group; a second call on copies of the same inputs
    gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    bufs = [[_views(n, off, dt, gen, cuda, 0.02), _views(n, off, torch.float32, gen, cuda, 1e-3),
             _views(n, off, torch.float32, gen, cuda, 1e-4),
             _views(n, off, torch.float32, gen, cuda, 1e-3).abs() ** 2]
            for n, off, dt in BUCKETS]
    copies = [[x.clone() for x in b] for b in bufs]
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    sc = dict(lr=torch.tensor(1e-3, device=cuda), c1=torch.tensor(0.19, device=cuda),
              c2=torch.tensor(0.0975, device=cuda), clip_scale=torch.tensor(clip, device=cuda))
    want = [ref.adamw_stats_ref(*b, **sc, **hyper) for b in bufs]
    scalars = adamw_scalars(*sc.values(), cuda)
    before = fused_adamw_stats.launches
    gsq = fused_adamw_stats_buckets(*zip(*bufs), scalars, **hyper)
    assert fused_adamw_stats.launches == before + 2
    again = fused_adamw_stats_buckets(*zip(*copies), scalars, **hyper)
    torch.cuda.synchronize()
    assert torch.equal(gsq, again)
    for b, c, w in zip(bufs, copies, want):
        for got, copy, expect in zip((b[0], b[2], b[3]), (c[0], c[2], c[3]), w):
            assert torch.equal(got, copy)
            tol = (dict(rtol=2 ** -8, atol=1e-9) if got.dtype == torch.bfloat16
                   else dict(rtol=1e-6, atol=1e-9))
            torch.testing.assert_close(got, expect, **tol)
    torch.testing.assert_close(gsq, sum(w[3] for w in want), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_stats_buckets_match_plain_loop(cuda):
    """One list call against `ref.fused_stats_ref` bucket by bucket, x and y
    f32, or bf16 and f32 (two dtype groups); one launch per group; repeated
    calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    xs = [_views(n, off, dt, gen, cuda) for n, off, dt in BUCKETS]
    ys = [_views(n, off, torch.float32, gen, cuda) for n, off, _ in BUCKETS]
    before = fused_stats.launches
    dsq, ysq = fused_stats_buckets(xs, ys)
    assert fused_stats.launches == before + 2
    dsq2, ysq2 = fused_stats_buckets(xs, ys)
    torch.cuda.synchronize()
    assert torch.equal(dsq, dsq2) and torch.equal(ysq, ysq2)
    want = [ref.fused_stats_ref(x, y) for x, y in zip(xs, ys)]
    torch.testing.assert_close(dsq, sum(w[0] for w in want), rtol=1e-5, atol=0)
    torch.testing.assert_close(ysq, sum(w[1] for w in want), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_bucket_table_is_cached_by_buffer(cuda):
    """The second call on the same buffers finds its table on the card; a
    changed buffer builds a new one, and the result follows the buffer."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [_views(n, 0, torch.float32, gen, cuda) for n in (17, 4096, 70_000)]
    ys = [_views(n, 0, torch.float32, gen, cuda) for n in (17, 4096, 70_000)]
    fused_stats_buckets(xs, ys)
    builds, hits = TABLES.builds, TABLES.hits
    fused_stats_buckets(xs, ys)
    assert (TABLES.builds, TABLES.hits) == (builds, hits + 1)
    ys[1] = 2 * ys[1]
    dsq, ysq = fused_stats_buckets(xs, ys)
    assert TABLES.builds == builds + 1
    want = [ref.fused_stats_ref(x, y) for x, y in zip(xs, ys)]
    torch.testing.assert_close(ysq, sum(w[1] for w in want), rtol=1e-5, atol=0)


BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 64), (7, 100), (4096, 2048), (33, 2050),
                                    (5, 8192),
                                    # prefill 2 x 2048 of deepseek-v2 (MLA's
                                    # kv_norm, q_norm; d_model), phi3-mini;
                                    # gemma2's 1 x 8192
                                    (4096, 512), (4096, 1536), (4096, 5120),
                                    (4096, 3072), (8192, 4608)])
@pytest.mark.parametrize("x_dtype,s_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_rmsnorm_matches_plain_version(cuda, rows, d, x_dtype, s_dtype, offset):
    """offset 1 starts x one element into a buffer (the scalar path)."""
    gen = torch.Generator(device=cuda).manual_seed(rows * d)
    x = torch.randn(rows * d + offset, device=cuda, generator=gen).to(x_dtype)
    x = x[offset:].view(rows, d)
    scale = (1 + 0.1 * torch.randn(d, device=cuda, generator=gen)).to(s_dtype)
    with torch.inference_mode():
        got = rmsnorm(x, scale)
        again = rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert got.dtype == x_dtype and got.shape == x.shape
    assert torch.equal(got, again)            # fixed order: bit-identical
    tol = dict(rtol=1e-5, atol=1e-5) if x_dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, scale), **tol)


FLASH_CASES = [  # b, t, s, h, kvh, d, causal, window, softcap
    (1, 64, 64, 4, 4, 64, True, 0, 0.0),
    (2, 100, 100, 8, 2, 64, True, 0, 0.0),
    (1, 77, 130, 4, 1, 32, True, 0, 30.0),
    (1, 200, 60, 4, 4, 128, True, 50, 0.0),      # rows 109+ see no key
    (2, 200, 200, 8, 8, 64, True, 100, 30.0),
    (1, 96, 150, 8, 4, 64, False, 0, 0.0),
    (1, 300, 300, 4, 1, 128, True, 100, 0.0),
    (2, 130, 130, 4, 4, 100, True, 0, 0.0),      # openllama-3b's head dim
    (1, 150, 90, 8, 2, 100, True, 50, 30.0),
    (1, 70, 70, 4, 2, 48, True, 0, 0.0),
    (1, 80, 120, 4, 1, 16, False, 0, 0.0),
    (1, 65, 65, 2, 2, 80, True, 0, 0.0),
    (4, 2048, 2048, 32, 8, 64, True, 0, 0.0),    # prefill of llama3.2-1b
    (2, 93, 157, 8, 4, 100, False, 0, 0.0),      # t, s not multiples of 16
    (1, 70, 90, 4, 1, 33, True, 0, 0.0),         # 4-byte copies; bf16: plain loads
    (1, 45, 45, 2, 1, 34, False, 0, 30.0),       # bf16: 4-byte copies
    # the archs' long prefills: gemma2-27b's local and global layers,
    # phi3-mini (head dim 96, MHA), nemotron-4 and dbrx (48 / 8 heads)
    (1, 8192, 8192, 32, 16, 128, True, 4096, 50.0),
    (1, 8192, 8192, 32, 16, 128, True, 0, 50.0),
    (2, 2048, 2048, 32, 32, 96, True, 0, 0.0),
    (2, 2048, 2048, 48, 8, 128, True, 0, 0.0),
    # recurrentgemma-9b's local layer (MQA 16 / 1, head dim 256, window
    # 2048); whisper-base's encoder and cross-attention over its 1500
    # frames (non-causal, t != s; prefill's 448 queries and decode's one);
    # internvl2-1b's 14 / 2 heads
    (1, 8192, 8192, 16, 1, 256, True, 2048, 0.0),
    (2, 1500, 1500, 8, 8, 64, False, 0, 0.0),
    (2, 448, 1500, 8, 8, 64, False, 0, 0.0),
    (2, 1, 1500, 8, 8, 64, False, 0, 0.0),
    (2, 2048, 2048, 14, 2, 64, True, 0, 0.0),
    # head dims past 128 (O in two halves, one a block), t and s off
    # multiples of 16
    (1, 77, 93, 4, 2, 136, True, 0, 0.0),
    (2, 61, 130, 4, 1, 200, False, 0, 30.0),
    (1, 150, 150, 4, 4, 256, True, 50, 0.0),
    (1, 83, 141, 2, 1, 256, False, 0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,kvh,d,causal,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain_version(cuda, b, t, s, h, kvh, d, causal,
                                                    window, softcap, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t * s + h)
    q, k, v = (torch.randn(b, n, heads, d, device=cuda, generator=gen).to(dtype)
               for n, heads in ((t, h), (s, kvh), (s, kvh)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    with torch.inference_mode():
        got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw), **tol)


LARGE_LOGIT_CASES = [  # b, t, s, h, kvh, d, causal
    (2, 200, 200, 8, 2, 64, True),
    (1, 300, 300, 4, 1, 128, True),
    (2, 93, 157, 8, 4, 100, False),
    (1, 2048, 2048, 4, 1, 64, True),
    (1, 300, 300, 4, 1, 256, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,kvh,d,causal", LARGE_LOGIT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("logit", [30.0, 50.0])
def test_cuda_flash_attention_large_logits(cuda, b, t, s, h, kvh, d, causal, dtype,
                                           logit):
    """q scaled so that the largest |logit| is 30, and 50 (gemma2-27b's
    attention softcap admits logits up to 50): the worst case of the
    split-TF32 products and of the tensor cores' accumulation, at the
    unchanged tolerances.  f32 is held against the same attention in f64,
    the exact answer: at these logits the plain f32 version's own error
    nears the 2e-5 (1.9e-5 at t 93, s 157, d 100 on the card), so the two
    f32 results could disagree by more with neither at fault.  bf16 is held
    against the plain version as before.  A miss reports the kernel's and
    the plain version's errors against f64 beside each other."""
    gen = torch.Generator(device=cuda).manual_seed(t * s + d)
    q, k, v = (torch.randn(b, n, heads, d, device=cuda, generator=gen)
               for n, heads in ((t, h), (s, kvh), (s, kvh)))
    kh = torch.repeat_interleave(k, h // kvh, dim=2)
    top = torch.einsum("bthd,bshd->bhts", q, kh).abs().max() / d ** 0.5
    q, k, v = ((q * (logit / top)).to(dtype), k.to(dtype), v.to(dtype))
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
    err = lambda a: float((a.double() - exact).abs().max())
    msg = lambda m: (f"{m}\nmax abs error against f64: kernel {err(got):.3e}, "
                     f"plain {err(plain):.3e}")
    if dtype == torch.float32:
        torch.testing.assert_close(got.double(), exact, rtol=2e-5, atol=2e-5, msg=msg)
    else:
        torch.testing.assert_close(got, plain, msg=msg, **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_repeats_bit_for_bit(cuda, dtype):
    """Two calls on the same inputs give the same bits (no atomics; every
    sum in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 300, 8, 64, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(2, 300, 2, 64, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    with torch.inference_mode():
        first = flash_attention(q, k, v, causal=True, window=100, softcap=30.0)
        again = flash_attention(q, k, v, causal=True, window=100, softcap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_forward_kernels_refuse_grad_and_odd_head_dims(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rmsnorm(x, torch.ones(64, device=cuda))
    q = torch.randn(1, 8, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    before = (rmsnorm.launches, flash_attention.launches)
    with torch.no_grad():
        rmsnorm(x, torch.ones(64, device=cuda))
    assert (rmsnorm.launches, flash_attention.launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cuda_dense_configs_forward_without_grad_and_prefill(cuda, arch):
    """Every registered config at its full width and the fewest layers
    that hold each of its layer kinds (its prefix and one block pattern;
    whisper's 6 encoder layers), audio frames or patch embeddings from the
    seeded generator: a forward with grad mode off (training's eval loss)
    runs the kernels — the launches `forward_kernel_launches` computes
    from the config — and agrees with the plain forward under grad mode;
    prefill (kernels) agrees with the same tokens streamed through decode
    (plain attention; chip_smoke's `prefill_vs_decode`), an MoE model at a
    capacity where no pair drops (a prefill row drops what a one-token
    decode row keeps).  f32 through the model: 1e-5 on the loss, 1e-4 of
    the largest magnitude on logits and caches (sums in another order over
    2000-6144 wide rows).  mamba2 takes 128 tokens, its chunk."""
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=len(cfg.prefix_pattern) + len(cfg.block_pattern))
    model = build_model(cfg)
    params = model.init(0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    vocab = model.cfg.vocab_size
    n = cfg.ssm.chunk_size if cfg.ssm is not None else 100
    tokens = torch.randint(0, vocab, (2, n), device=cuda, generator=gen)
    labels = torch.randint(0, vocab, (2, n), device=cuda, generator=gen)
    front = frontend_inputs(cfg, 2, gen, cuda)
    batch = {"tokens": tokens, "labels": labels, **front}
    plain = model.loss(params, batch)[0]
    ops.reset_launch_counts()
    with torch.no_grad():
        fast = model.loss(params, batch)[0]
    counts, want = ops.launch_counts(), forward_kernel_launches(cfg)
    assert {k: counts[k] for k in want} == want, counts
    torch.testing.assert_close(fast, plain.detach(), rtol=1e-5, atol=0)
    if cfg.moe is not None:
        model = build_model(cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts))))
    errs = prefill_vs_decode(model, params, tokens, front, cuda)
    torch.cuda.synchronize()
    assert max(errs.values()) <= 1e-4, errs


# the tree routes: 40 tiny leaves, an empty one, a larger one; f32 and bf16
TREE_LEAVES = ([(1 + i % 5, torch.float32 if i % 3 else torch.bfloat16)
                for i in range(40)]
               + [(0, torch.float32), (37 * 129, torch.bfloat16), (70_001, torch.float32)])


@pytest.mark.cuda
def test_cuda_tree_routes_one_launch_per_dtype_group_and_bit_identical(cuda):
    """`ops.sqdiff_norm_tree` and `ops.fused_adamw_tree` over many tiny
    leaves, an empty leaf and mixed f32/bf16: one launch per dtype group,
    the plain versions leaf by leaf within the per-tensor kernels'
    tolerances, and two calls on the same inputs the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(n, device=cuda, generator=gen).to(dt) for n, dt in TREE_LEAVES]
    ys = [torch.randn(n, device=cuda, generator=gen).to(dt) for n, dt in TREE_LEAVES]
    tree = lambda leaves: {"a": leaves[:20], "b": {"c": leaves[20:]}}
    groups = len({dt for _, dt in TREE_LEAVES})
    before = sqdiff_norm.launches
    got = ops.sqdiff_norm_tree(tree(xs), tree(ys))
    assert sqdiff_norm.launches == before + groups
    again = ops.sqdiff_norm_tree(tree(xs), tree(ys))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, sum(ref.sqdiff_norm_ref(x, y) for x, y in zip(xs, ys)),
                               rtol=1e-5, atol=0)
    ms = [1e-3 * torch.randn(n, device=cuda, generator=gen) for n, _ in TREE_LEAVES]
    vs = [1e-6 * torch.rand(n, device=cuda, generator=gen) for n, _ in TREE_LEAVES]
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    sc = dict(lr=torch.tensor(1e-3), c1=torch.tensor(0.19, device=cuda),
              c2=torch.tensor(0.0975, device=cuda))
    want = [ref.adamw_ref(p, g, m, v, **sc, **hyper) for p, g, m, v in zip(xs, ys, ms, vs)]
    copies = [[t.clone() for t in leaves] for leaves in (xs, ms, vs)]
    before = fused_adamw.launches
    out = ops.fused_adamw_tree(tree(xs), tree(ys), tree(ms), tree(vs), **sc, **hyper)
    assert fused_adamw.launches == before + groups
    assert out[0]["a"][0] is xs[0]
    ops.fused_adamw_tree(tree(copies[0]), tree(ys), tree(copies[1]), tree(copies[2]),
                         **sc, **hyper)
    torch.cuda.synchronize()
    for leaves, cps, idx in ((xs, copies[0], 0), (ms, copies[1], 1), (vs, copies[2], 2)):
        for t, c, w in zip(leaves, cps, want):
            assert torch.equal(t, c)
            tol = (dict(rtol=2 ** -8, atol=1e-9) if t.dtype == torch.bfloat16
                   else dict(rtol=1e-6, atol=1e-9))
            torch.testing.assert_close(t, w[idx], **tol)


@pytest.mark.cuda
def test_cuda_adamw_scalars_one_pinned_upload(cuda):
    """The scalars: the host's lr (a CPU tensor, as the schedule makes it)
    and a float go up together without blocking; the card's c1 and c2
    stay; every value exact in f32."""
    lr = torch.tensor(3e-4)
    c1, c2 = torch.tensor(0.19, device=cuda), torch.tensor(0.0975, device=cuda)
    s = adamw_scalars(lr, c1, c2, 0.5, cuda)
    assert s.device.type == "cuda" and s.dtype == torch.float32
    assert s.cpu().tolist() == torch.tensor([3e-4, 0.19, 0.0975, 0.5]).tolist()


@pytest.mark.cuda
def test_cuda_graphed_decode_matches_eager_and_counts_replays(cuda):
    """A rung's decode step captured as a CUDA graph (llama3.2-1b smoke,
    4 slots): the same greedy tokens and caches as the eager slot step
    from the same state, step after step; the capture launches nothing,
    each replay adds its captured rmsnorm launches, and the warm-up run
    before capture left the cache's rows alone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.serve_step import GraphedDecode, make_slot_decode_step
    model = build_model(get_smoke_config("llama3.2-1b"))
    params = model.init(0, cuda)
    b, steps = 4, 6
    eager_cache, graph_cache = (model.init_cache(b, 16, device=cuda) for _ in range(2))
    step = make_slot_decode_step(model, max_slots=b)(b)
    ops.reset_launch_counts()
    graph = GraphedDecode(step, params, graph_cache, b)
    warm = ops.launch_counts()["rmsnorm"]            # the warm-up run's, real
    assert warm == 2 * model.cfg.num_layers + 1
    assert all(not x.any() for layer in graph_cache for x in layer.values())
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, model.cfg.vocab_size, (b,), generator=gen, dtype=torch.int32)
    for i in range(steps):
        pos = torch.tensor([i, i + 1, i, i + 2], dtype=torch.int32)
        want, _ = step(params, eager_cache, tok.to(cuda), pos.to(cuda))
        got, _ = graph(params, graph_cache, tok, pos)
        assert torch.equal(got, want), i
        tok = got.cpu()
    torch.cuda.synchronize()
    for a, c in zip(eager_cache, graph_cache):
        for k in a:
            torch.testing.assert_close(c[k], a[k], rtol=1e-6, atol=1e-6)
    assert ops.launch_counts()["rmsnorm"] == warm + 2 * steps * (2 * model.cfg.num_layers + 1)


@pytest.mark.cuda
def test_cuda_serve_engine_graph_rungs_match_the_cpu(cuda):
    """The continuous-batching engine on the card (every rung a captured
    graph, warm-up on) serves the same greedy tokens as on the CPU from
    the same parameters; every rung change after the ladder is warmed is a
    hit with no new build."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.serve_engine import ServeEngine
    from repro_torch.tree import tree_map
    model = build_model(get_smoke_config("llama3.2-1b"))
    params = model.init(0, "cpu")
    r = np.random.RandomState(0)
    prompts = [r.randint(0, model.cfg.vocab_size, size=(r.randint(1, 5),)).astype(np.int32)
               for _ in range(6)]
    out = {}
    for d in ("cpu", "cuda"):
        p = params if d == "cpu" else tree_map(lambda x: x.to(cuda), params)
        eng = ServeEngine(model, p, max_slots=4, cache_len=16, aot_warmup=True)
        eng.warm(eng.ladder)
        compiles = eng.stats.compiles
        reqs = [eng.submit(pr, max_new_tokens=4) for pr in prompts]
        eng.run_until_drained()
        assert eng.stats.compiles == compiles
        assert eng.stats.transition_hits == eng.stats.rung_transitions >= 1
        out[d] = [q.generated for q in reqs]
    assert out["cuda"] == out["cpu"]


# ------------------------------------------------------------- dense GEMM

@pytest.fixture
def f32_matmul(cuda):
    """cuBLAS in full f32 for the yardstick, as the training step sets it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("name,k,n,table", DENSE_SHAPES)
def test_cuda_dense_main_path_products_within_twice_cublas(cuda, f32_matmul, name, k, n,
                                                           table, kind):
    """Each main-path product (phi3-mini's widths, 4096 rows) in the layout
    `Dense` hands it: the error against f64 at most 2 x cuBLAS's f32 error,
    a rerun bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    a, b = dense_operands(DENSE_ROWS, k, n, table, gen, cuda)[kind]
    e = dense_errors(dense_mod.dense_mm, a, b)
    assert e["rerun_equal"] and e["kernel"] <= 2 * e["matmul"], e


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("a_k,b_k", [(True, True), (True, False), (False, True),
                                     (False, False)])
@pytest.mark.parametrize("m,n,k", DENSE_RAGGED)
def test_cuda_dense_ragged_every_layout(cuda, f32_matmul, m, n, k, a_k, b_k, offset):
    """Ragged M, N and K in every layout, 16-byte copies (offset 0) and
    4-byte ones (a view one element in): masked edges, no padding."""
    gen = torch.Generator(device=cuda).manual_seed(m * n + k)
    a = torch.randn(m * k + offset, device=cuda, generator=gen)[offset:]
    b = torch.randn(k * n + offset, device=cuda, generator=gen)[offset:]
    a = a.view(m, k) if a_k else a.view(k, m).t()
    b = b.view(n, k).t() if b_k else b.view(k, n)
    e = dense_errors(dense_mod.dense_mm, a, b)
    assert e["rerun_equal"] and e["kernel"] <= max(2 * e["matmul"], DENSE_FLOOR), e


EINSUMS = [  # every product the model routes, at 128 rows
    ("btd,dhk->bthk", (2, 64, 96), (96, 4, 24)),
    ("bthk,hkd->btd", (2, 64, 4, 24), (4, 24, 96)),
    ("btd,df->btf", (1, 128, 96), (96, 200)),
    ("btf,fd->btd", (1, 128, 200), (200, 96)),
    ("...d,vd->...v", (2, 64, 96), (1000, 96)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("eq,xs,ws", EINSUMS)
def test_cuda_dense_gradients_match_the_einsum(cuda, f32_matmul, eq, xs, ws):
    """`ops.dense` on f32 with >= 64 rows: one launch forward, two
    backward, output and both gradients the einsum's; decode's rows and
    bf16 take the einsum and launch nothing."""
    gen = torch.Generator(device=cuda).manual_seed(len(eq))
    x = torch.randn(*xs, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(*ws, device=cuda, generator=gen, requires_grad=True)
    y = torch.einsum(eq, x, w)
    dy = torch.randn(y.shape, device=cuda, generator=gen)
    want = torch.autograd.grad(y, (x, w), dy)
    before = ops.launch_counts()["dense"]
    got_y = ops.dense(eq, x, w)
    got = torch.autograd.grad(got_y, (x, w), dy)
    assert ops.launch_counts()["dense"] == before + 3
    # two f32 sums of up to 1000 terms in different orders: an error of
    # the order of 1e-6 of the largest magnitude
    close = lambda a, b: torch.testing.assert_close(
        a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    close(got_y, y)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        close(a, b)
    calls = ops.call_counts()["dense"]
    x1 = x.detach()[:1, :1]                  # one row: decode
    torch.testing.assert_close(ops.dense(eq, x1, w.detach()),
                               torch.einsum(eq, x1, w.detach()), rtol=0, atol=0)
    xb, wb = x.detach().bfloat16(), w.detach().bfloat16()
    assert torch.equal(ops.dense(eq, xb, wb), torch.einsum(eq, xb, wb))
    assert ops.launch_counts()["dense"] == before + 3
    assert ops.call_counts()["dense"] == calls + 2


@pytest.mark.cuda
def test_cuda_dense_per_sample_gradients_keep_the_einsum(cuda, f32_matmul):
    """`torch.func.vmap(torch.func.grad(...))` over a model's loss, 96
    tokens a sample (rows over `MIN_ROWS` in every product): `ops.dense`
    takes the einsum inside the transform (`Dense` has no vmap rule) and
    launches nothing; the per-sample gradients' mean is the batch's
    gradient."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("microllama-300m")
    model = build_model(cfg)
    params = model.init(0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (4, 97), device=cuda, generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss = lambda p, ex: model.loss(p, {k: v[None] for k, v in ex.items()})[0]
    before = ops.launch_counts()["dense"]
    per = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, batch)
    assert ops.launch_counts()["dense"] == before
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    whole = torch.autograd.grad(model.loss(params, batch)[0], leaves)
    for a, b in zip(_leaves(per), whole):
        torch.testing.assert_close(a.mean(0), b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_dense_every_projection_of_a_training_step(cuda, f32_matmul):
    """A smoke phi3-mini forward and backward on the card: three launches
    (forward, dX, dW) for each of a layer's seven projections and the
    head's; the loss and the gradients the plain einsums' (rows under 64
    take the einsum: the same model at one row of 32 tokens)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("phi3-mini-3.8b")
    model = build_model(cfg)
    params = model.init(0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda, generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    leaves = [p for p in _leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    before = ops.launch_counts()["dense"]
    loss = model.loss(params, batch)[0]
    grads = torch.autograd.grad(loss, leaves)
    assert ops.launch_counts()["dense"] - before == 3 * (7 * cfg.num_layers + 1)
    old = dense_mod.MIN_ROWS
    dense_mod.MIN_ROWS = 10 ** 9             # every product through the einsum
    try:
        plain = model.loss(params, batch)[0]
        plain_grads = torch.autograd.grad(plain, leaves)
    finally:
        dense_mod.MIN_ROWS = old
    torch.testing.assert_close(loss, plain, rtol=1e-5, atol=0)
    for a, b in zip(grads, plain_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.cuda
def test_cuda_dry_run_counts_the_step_flops_on_the_kernels_route(cuda):
    """The dry-run's trace of a phi3-mini smoke ACCUM-NORM step on fake
    CUDA tensors (the kernels' route) counts the same FLOPs as with every
    product on the einsum, its projections (forward, dX, dW) in the
    `split_tf32` class."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import InputShape, train_inputs
    from repro_torch.launch import dryrun
    cfg = get_smoke_config("phi3-mini-3.8b")
    batch_like = train_inputs(cfg, InputShape("t", 64, 2, "train"))
    routed, _ = dryrun.trace_train(cfg, batch_like, None, "cuda", step_impl="accum_norm")
    old = dense_mod.MIN_ROWS
    dense_mod.MIN_ROWS = 10 ** 9
    try:
        plain, _ = dryrun.trace_train(cfg, batch_like, None, "cuda", step_impl="accum_norm")
    finally:
        dense_mod.MIN_ROWS = old
    assert routed.cost["flops"] == plain.cost["flops"]
    rows = 2 * 64
    per_layer = (2 * cfg.d_model * cfg.num_heads * cfg.head_dim
                 + 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
                 + 3 * cfg.d_model * cfg.d_ff)
    want = 3 * 2 * rows * (cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size)
    assert routed.cost["flops_by_class"]["split_tf32"] == want
    assert routed.kernel_calls["dense"] == 3 * (7 * cfg.num_layers + 1)
