"""The split-TF32 `dense` kernel's arithmetic, emulated on the CPU, and its
op around it: the routing, the autograd function and the dry-run's count.

The kernel (`src/repro_torch/kernels/csrc/dense.cu`) computes C = A·B in
f32 on the tensor cores: each operand is split as x = hi + lo, hi = x
rounded to TF32 (`cvt.rna`: nearest, ties away from zero) and lo = x - hi
rounded the same way; each 32-deep slice of K is lo·hi + hi·lo + hi·hi in
a fresh accumulator, and the slices are added in f32, rounded to nearest.
Here the rounding is a bit operation on f32 tensors and each slice's
products are f32 matrix products of the rounded operands, at the main
path's K (phi3-mini: d 3072, ffn 8192, a microbatch of 4096 rows as dW's K,
the vocabulary 32064 as the head's dX's K), with M and N cut small.  The
emulation must err against f64 within the f32 product's own error: that of
the product summed term by term along K in f32, as an FFMA GEMM (cuBLAS's
f32 kernels, which the kernel replaces) sums each output; the card test
holds the kernel to twice cuBLAS's error.  One TF32 product must miss it by
far.  How the tensor cores round inside a slice
cannot be seen here: the card tests (`tests/test_torch_cuda.py`, marked
`cuda`) judge that.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import InputShape, train_inputs
from repro_torch.kernels import dense as dense_mod
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from test_torch_flash_split import split, tf32

SLICE = 32                       # K a fresh accumulator sums (dense.cu's BK)
MAIN_K = [3072, 8192, 4096, 32064]
M, N = 64, 48                    # cut from 4096 rows and 3072-32064 columns


def operands(k, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((M, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, N), dtype=np.float32))
    return a, b


def emulate(a, b):
    """The kernel's sum: K zero-padded to whole slices, each slice's three
    TF32 products (the small ones first) in a fresh f32 accumulator, the
    slices added in order in f32."""
    k = a.shape[1]
    pad = -k % SLICE
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    slices = a.shape[1] // SLICE
    ah, al = split(a.reshape(M, slices, SLICE).transpose(0, 1))
    bh, bl = split(b.reshape(slices, SLICE, N))
    acc = (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)
    total = torch.zeros(M, N)
    for s in range(slices):
        total = total + acc[s]
    return total


def sequential_f32(a, b):
    """The f32 product summed along K one term at a time, rounded at every
    step (each output's sum in an FFMA GEMM)."""
    total = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        total = total + a[:, k, None] * b[None, k, :]
    return total


def rel_err(got, want):
    """Max abs error over the largest magnitude, against f64."""
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("k", MAIN_K)
def test_3xtf32_slices_within_the_f32_products_error(k):
    a, b = operands(k, k)
    want = a.double() @ b.double()
    plain = rel_err(sequential_f32(a, b), want)
    got = rel_err(emulate(a, b), want)
    assert got <= 2 * plain, (got, plain)
    # one TF32 product: ~5e-4 a product, far outside
    assert rel_err(tf32(a) @ tf32(b), want) > 20 * plain


def test_ragged_k_pads_with_exact_zeros():
    a, b = operands(33, 1)
    want = a.double() @ b.double()
    assert rel_err(emulate(a, b), want) <= 2.0 ** -21


def test_split_parts_are_tf32_and_sum_back():
    a, _ = operands(4096, 2)
    hi, lo = split(a)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    # what hi + lo leaves out is lo's own rounding: under 2^-21 of |x|
    assert float(((hi + lo) - a).abs().max() / a.abs().max()) < 2.0 ** -21


# ------------------------------------------------------------ the op ----

EINSUMS = [  # eq, x shape, w shape: every product the model routes
    ("btd,dhk->bthk", (2, 40, 12), (12, 3, 5)),
    ("bthk,hkd->btd", (2, 40, 3, 5), (3, 5, 12)),
    ("btd,df->btf", (1, 70, 12), (12, 9)),
    ("btf,fd->btd", (1, 70, 9), (9, 12)),
    ("bsd,dhk->bshk", (2, 33, 12), (12, 2, 4)),
    ("...d,vd->...v", (2, 40, 12), (33, 12)),
]


def _views(eq, x, w):
    """The 2-D views `ops.dense` hands the autograd function."""
    kdims, w_kmajor = ops._dense_plan(eq)
    k = int(np.prod(x.shape[x.dim() - kdims:]))
    w2 = w.reshape(-1, k).t() if w_kmajor else w.reshape(k, -1)
    free = w.shape[:w.dim() - kdims] if w_kmajor else w.shape[kdims:]
    return x.reshape(-1, k), w2, (*x.shape[:x.dim() - kdims], *free)


@pytest.mark.parametrize("eq,xs,ws", EINSUMS)
def test_dense_function_equals_the_einsum_with_gradients(eq, xs, ws, monkeypatch):
    """`Dense`, its launches made by `torch.mm` here, gives the einsum's
    output and both gradients in f64 to the bit, the weight's gradient in
    the weight's own layout (the head's (v, d) table contiguous)."""
    monkeypatch.setattr(dense_mod, "dense_mm", torch.mm)
    g = torch.Generator().manual_seed(len(eq))
    x = torch.randn(*xs, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(*ws, generator=g, dtype=torch.float64, requires_grad=True)
    y = torch.einsum(eq, x, w)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(y, (x, w), dy)
    x2, w2, shape = _views(eq, x, w)
    got_y = dense_mod.Dense.apply(x2, w2).view(shape)
    got = torch.autograd.grad(got_y, (x, w), dy)
    assert torch.equal(got_y, y)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].is_contiguous()


def test_dense_routes_off_the_card_to_the_einsum_and_counts():
    """On the CPU every call is the einsum itself, counted once in
    `call_counts()`, never in `launch_counts()`; a product that is no
    product against a weight is refused."""
    g = torch.Generator().manual_seed(3)
    before_calls, before_launches = ops.call_counts(), ops.launch_counts()
    for eq, xs, ws in EINSUMS:
        x, w = torch.randn(*xs, generator=g), torch.randn(*ws, generator=g)
        assert torch.equal(ops.dense(eq, x, w), torch.einsum(eq, x, w))
    calls = ops.call_counts()
    assert calls["dense"] - before_calls["dense"] == len(EINSUMS)
    assert ops.launch_counts() == before_launches
    assert {k: calls[k] - before_calls[k] for k in calls if k != "dense"} == \
        {k: 0 for k in calls if k != "dense"}
    for eq in ("bhts,bshd->bthd", "btd,dhk->btk"):
        with pytest.raises(ValueError, match="not a product against a weight"):
            ops._dense_plan(eq)
    assert ops._dense_plan("bthk,hkd->btd") == (2, False)
    assert ops._dense_plan("...d,vd->...v") == (1, True)


def test_dense_rule_reads_the_operands_and_leaves_torch_func_to_the_einsum():
    """The kernel's rule: f32 operands on the card with at least `MIN_ROWS`
    rows; not bf16, not the CPU, and not inside a `torch.func` transform
    (`Dense` has no vmap rule), where per-sample gradients keep the
    einsum.  Operands stand in by their device and dtype alone."""
    card = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    bf16 = SimpleNamespace(device=torch.device("cuda"), dtype=torch.bfloat16)
    cpu = SimpleNamespace(device=torch.device("cpu"), dtype=torch.float32)
    rows = dense_mod.MIN_ROWS
    assert ops._dense_routed(card, card, rows)
    assert not ops._dense_routed(card, card, rows - 1)
    assert not ops._dense_routed(bf16, bf16, 4096)
    assert not ops._dense_routed(cpu, cpu, 4096)
    seen = []
    torch.func.vmap(lambda v: seen.append(ops._dense_routed(card, card, 4096)) or v)(
        torch.ones(2))
    torch.func.grad(lambda v: seen.append(ops._dense_routed(card, card, 4096)) or v.sum())(
        torch.ones(2))
    assert seen == [False, False]


def test_dense_flop_formula_and_fake_output():
    """2·M·N·K a launch; the fake implementation makes only the output."""
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        a, b = torch.empty(70, 12), torch.empty(33, 12).t()
        with FlopCounterMode(display=False) as fc:
            out = dense_mod.dense_op(a, b)
    assert fc.get_total_flops() == 2 * 70 * 33 * 12
    assert tuple(out.shape) == (70, 33) and out.dtype == torch.float32


def _trace_step(cfg, batch_like):
    tr, _ = dryrun.trace_train(cfg, batch_like, None, "cpu", step_impl="accum_norm")
    return tr


def test_dry_run_counts_the_same_flops_through_the_kernel_route(monkeypatch):
    """A phi3-mini smoke ACCUM-NORM step traced on fake tensors counts the
    same FLOPs whether its projections take the einsum or the kernel's
    route (forward, dX and dW through `Dense`, each a `repro_torch::dense`
    op under its fake implementation); on the kernel's route they are the
    `split_tf32` class, the projections' share of the step's FLOPs.  (The
    kernel's route is taken here on fake CPU tensors: a torch without CUDA
    cannot trace a backward on fake CUDA ones.)"""
    cfg = get_smoke_config("phi3-mini-3.8b")
    batch_like = train_inputs(cfg, InputShape("t", 64, 2, "train"))
    plain = _trace_step(cfg, batch_like)
    monkeypatch.setattr(ops, "_dense_routed",
                        lambda x, w, rows: x.dtype == torch.float32
                        and rows >= dense_mod.MIN_ROWS)
    monkeypatch.setattr(dense_mod, "dense_mm", dense_mod.dense_op)
    routed = _trace_step(cfg, batch_like)
    assert routed.cost["flops"] == plain.cost["flops"] > 0
    split_flops = routed.cost["flops_by_class"]["split_tf32"]
    assert "split_tf32" not in plain.cost["flops_by_class"]
    # 7 projections a layer and the head, each 3 products of 2·rows·d_in·d_out
    rows = 2 * 64
    per_layer = (2 * cfg.d_model * cfg.num_heads * cfg.head_dim
                 + 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
                 + 3 * cfg.d_model * cfg.d_ff)
    want = 3 * 2 * rows * (cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size)
    assert split_flops == want
    assert 0 < split_flops < routed.cost["flops"]
