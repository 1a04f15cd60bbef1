"""The arithmetic of the tensor-core `flash_attention` kernel, emulated on
the CPU: why f32 inputs take three TF32 products ("3xTF32") and not one.

The kernel (`src/repro_torch/kernels/csrc/flash_attention.cu`) runs both
products of f32 attention, S = Q.K^T and O = P.V, on the tensor cores in
TF32.  Each operand is split as x = hi + lo, hi = x rounded to TF32
(`cvt.rna`: round to nearest, ties away from zero, 10 mantissa bits) and
lo = x - hi rounded the same way, and each product is lo*hi + hi*lo +
hi*hi with f32 accumulation.  Here the rounding is a bit operation on f32
tensors and the products are f32 matrix products of the rounded operands,
inside a plain online softmax over the kernel's key tiles (64 keys, 32 or
16 at the larger head dims, as `tile_keys` computes) with its masking
order (-2e38, rows that see no key get the mean of v).  The card test holds
the kernel to the plain version at rtol = atol = 2e-5 (f32); the emulation
must stay inside that, also with q scaled so that logits reach +-30, while
one TF32 product must miss it.  How the tensor cores round inside their
sums cannot be seen here: the card tests (`tests/test_torch_cuda.py`,
marked `cuda`) are the judge of that.

The shapes are the card test's `FLASH_CASES`, with the prefill case cut
from 4 x 32 q heads to 1 x 4 (t, s and d kept) to stay within seconds.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_cuda import FLASH_CASES

F32_TOL = dict(rtol=2e-5, atol=2e-5)     # the card test's f32 tolerance
SMEM_MAX = 232448                        # shared memory a block may have
NEG = -2.0e38
MAX_LOGITS = [None, 30.0]                # q as drawn, or scaled to |logit| <= 30
MAX_WORK = 2 ** 26                       # b * h * t * s above this is cut


def tf32(x):
    """x rounded to TF32, nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def matmul_tf32(a, b):
    return tf32(a) @ tf32(b)


S_CHUNK = 32          # columns of d a chunk of S past head dim 128


def logits_3xtf32(a, b):
    """S = Q K^T as the kernel computes it: past head dim 128 (a padded
    width of 144 or more) in chunks of 32 columns of d (16 where the padded
    width is an odd multiple of 16), each chunk three TF32 products in a
    fresh f32 accumulator, the chunks summed exactly (the kernel's
    compensated two-sum) and rounded once; up to 128 in one accumulator."""
    dp = -(-a.shape[-1] // 16) * 16
    if dp <= 128:
        return matmul_3xtf32(a, b)
    width = 16 if dp % 32 else S_CHUNK
    total = 0
    for c in range(0, a.shape[-1], width):
        total = total + matmul_3xtf32(a[..., c:c + width], b[..., c:c + width, :]).double()
    return total.float()


def tile_keys(d: int) -> int:
    """Keys a tile of the f32 kernel at head dim d (its `F32Tiles`): the
    head dim padded to 16 (dp), O's columns a block (do: all up to 128,
    else half rounded up to 16), and the widest tile of 64, 32 or 16 keys
    whose shared memory fits beside the q rows."""
    dp = -(-d // 16) * 16
    do = dp if dp <= 128 else -(-dp // 32) * 16
    size = lambda bq, bk: 4 * (2 * bq * dp + 3 * bk * dp + 6 * bk * do)
    bq = 128 if size(128, 64) <= SMEM_MAX else 64
    return next(bk for bk in (64, 32, 16) if size(bq, bk) <= SMEM_MAX)


def test_tile_keys_follow_the_kernel_layout():
    assert [tile_keys(d) for d in (64, 100, 128, 176, 192, 256)] == \
        [64, 32, 32, 32, 16, 16]


QB = 1024            # q rows emulated together


def emulate(q, k, v, *, causal, window, softcap, matmul, logits=None):
    """Online-softmax attention over the kernel's key tiles with `matmul`
    for both products (`logits`, when given, for S).  q: (b, t, h, d); k,
    v: (b, s, kvh, d), f32.  Blocks of QB q rows skip the key tiles that
    no row of theirs sees, as the kernel's blocks do (a skipped tile would
    leave every row as it was)."""
    logits = logits or matmul
    b, t, h, d = q.shape
    BK = tile_keys(d)
    s = k.shape[1]
    group = h // k.shape[2]
    kh = torch.repeat_interleave(k, group, dim=2).transpose(1, 2)
    vh = torch.repeat_interleave(v, group, dim=2).transpose(1, 2)
    outs = []
    for q0 in range(0, t, QB):
        rows = min(QB, t - q0)
        lo = max(0, (q0 - window + 1) // BK) if window > 0 else 0
        hi = min(-(-s // BK), (q0 + rows - 1) // BK + 1) if causal else -(-s // BK)
        outs.append(_emulate_rows(q[:, q0:q0 + rows], kh, vh, q0, lo * BK,
                                  max(lo, hi) * BK, BK, causal=causal, window=window,
                                  softcap=softcap, matmul=matmul, logits=logits))
    return torch.cat(outs, dim=1)


def _emulate_rows(q, kh, vh, q0, k_lo, k_hi, BK, *, causal, window, softcap, matmul,
                  logits):
    b, t, h, d = q.shape
    s = kh.shape[2]
    qh = q.transpose(1, 2)                                   # (b, h, t, d)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, t, 1), NEG)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    qpos = torch.arange(q0, q0 + t)[:, None]
    for k0 in range(k_lo, min(k_hi, s), BK):
        kpos = torch.arange(k0, min(k0 + BK, s))[None, :]
        x = logits(qh, kh[:, :, k0:k0 + BK].transpose(-1, -2)) * scale
        if softcap > 0:
            x = softcap * torch.tanh(x / softcap)
        ok = torch.ones((t, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        x = torch.where(ok, x, torch.tensor(NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr + matmul(p, vh[:, :, k0:k0 + BK])
        m = m_new
    dead = m == NEG                           # rows that saw no key
    acc = torch.where(dead, vh.sum(2, keepdim=True), acc)
    l = torch.where(dead, torch.tensor(float(s)), l)
    out = acc / torch.where(l == 0, torch.tensor(1.0), l)
    return out.transpose(1, 2)


def inputs(b, t, s, h, kvh, d, max_logit):
    """q, k, v from a seed; with `max_logit`, q scaled so that the largest
    |q.k| / sqrt(d) is that (the split's worst case: large logits)."""
    rng = np.random.default_rng(t * s + h * d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), dtype=np.float32))
               for n, heads in ((t, h), (s, kvh), (s, kvh)))
    if max_logit is not None:
        kh = torch.repeat_interleave(k, h // kvh, dim=2)
        top = torch.einsum("bthd,bshd->bhts", q, kh).abs().max() / math.sqrt(d)
        q = q * (max_logit / top)
    return q, k, v


def cut(case):
    b, t, s, h, kvh, d, causal, window, softcap = case
    if b * h * t * s > MAX_WORK:
        b, h, kvh = 1, 4, 1              # GQA group 4, as prefill's 32 / 8
    return b, t, s, h, kvh, d, causal, window, softcap


CASES = [cut(c) for c in FLASH_CASES]


@pytest.mark.parametrize("max_logit", MAX_LOGITS)
@pytest.mark.parametrize("b,t,s,h,kvh,d,causal,window,softcap", CASES)
def test_3xtf32_flash_within_f32_tolerance(b, t, s, h, kvh, d, causal, window, softcap,
                                           max_logit):
    q, k, v = inputs(b, t, s, h, kvh, d, max_logit)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = emulate(q, k, v, **kw, matmul=matmul_3xtf32, logits=logits_3xtf32)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_one_tf32_product_misses_f32_tolerance():
    """The reason for three products: one TF32 product misses 2e-5."""
    misses = []
    for case in CASES[:4]:
        b, t, s, h, kvh, d, causal, window, softcap = case
        q, k, v = inputs(b, t, s, h, kvh, d, MAX_LOGITS[-1])
        kw = dict(causal=causal, window=window, softcap=softcap)
        want = ref.flash_attention_ref(q, k, v, **kw)
        got = emulate(q, k, v, **kw, matmul=matmul_tf32)
        if not torch.allclose(got, want, **F32_TOL):
            misses.append(case)
    assert misses, "one TF32 product met the f32 tolerance on every case"


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, 0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0, 1.0 + 2.0 ** -10, 0.0])
    assert torch.equal(tf32(x), want)
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert torch.equal(hi + lo, x)       # exact for these: lo fits TF32
