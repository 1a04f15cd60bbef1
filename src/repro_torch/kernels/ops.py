"""Public entry points of the port's kernels, dispatched by the device of
the tensors passed in (counterpart of `repro/kernels/ops.py`):

* a CUDA tensor goes to the hand-written kernel — or the call raises;
* a CPU tensor goes to the kernel's plain PyTorch version in `ref.py`.

There is no environment override and no fallback: a tensor on the card
never reaches the plain version.  The reference's per-tensor wrappers
(`fused_stats`, `sqdiff_norm`, `fused_adamw`) and its flat hot-path ones
(`stats_flat`, `adamw_flat`) dispatch the same way here, and so do the
training step's calls over every bucket at once (`stats_flat_buckets`,
`adamw_flat_buckets`: one launch per dtype group on the card, the plain
version bucket by bucket on the CPU) and the serving path's forward-only
`rmsnorm` and `flash_attention`, whose kernels raise under grad mode on a
tensor that requires grad.  The model calls those two wherever the card
launches them, on every device, and hands them its own plain code for the
CPU (`plain=`).  `dense`, the model's products against its weights, routes
by what it is given: f32 operands on the card with at least one wgmma row
tile of rows take the split-TF32 kernel, forward and both gradients; every
other call (decode's rows, bf16, the CPU, a `torch.func` transform) the
einsum it names.

Each kernel is a PyTorch custom op (`repro_torch::<name>`) with a fake
implementation, so under `FakeTensorMode` a fake CUDA tensor takes the
card's route and makes only the outputs (the dry-run, `launch/dryrun.py`).
`launch_counts` are the wrappers' launches; `call_counts` add the calls
that ran a plain version, counted as the launches the card would make.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch.kernels import dense as _dense
from repro_torch.kernels import fused_adamw as _fa
from repro_torch.kernels import fused_stats as _fs
from repro_torch.kernels import ref
from repro_torch.kernels.buckets import launches
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.sqdiff_norm import sqdiff_norm as _sqdiff_norm
from repro_torch.kernels.sqdiff_norm import sqdiff_norm_buckets as _sqdiff_norm_buckets
from repro_torch.tree import tree_leaves


def _on_card(kernel: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{kernel}: no implementation for {t.device}")
    return False


def sqdiff_norm(x, y):
    """Σ(x−y)² in f32 as a 0-d tensor on x's device."""
    if _on_card("sqdiff_norm", x):
        return _sqdiff_norm(x, y)
    _note("sqdiff_norm", [(x, y)])
    return ref.sqdiff_norm_ref(x, y)


def sqdiff_norm_tree(tree_a, tree_b):
    """Σ‖a−b‖² over a whole gradient tree (the norm-test statistic's
    `sqdiff_fn`): on the card one `sqdiff_norm` launch per dtype group over
    every leaf pair, its per-block partials added in a fixed order; on the
    CPU the plain version leaf by leaf, summed in leaf order."""
    leaves_a, leaves_b = tree_leaves(tree_a), tree_leaves(tree_b)
    if len(leaves_a) != len(leaves_b):
        raise ValueError(f"sqdiff_norm_tree: {len(leaves_a)} and "
                         f"{len(leaves_b)} leaves")
    if leaves_a and _on_card("sqdiff_norm_tree", leaves_a[0]):
        return _sqdiff_norm_buckets(leaves_a, leaves_b)
    _note("sqdiff_norm", list(zip(leaves_a, leaves_b)))
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves_a[0].device if leaves_a else "cpu")
    for a, b in zip(leaves_a, leaves_b):
        total = total + ref.sqdiff_norm_ref(a, b)
    return total


def fused_stats(x, y):
    """(Σ(x−y)², Σy²) in one read of each operand, as two 0-d f32 tensors."""
    if _on_card("fused_stats", x):
        return _fs.fused_stats(x, y)
    _note("fused_stats", [(x, y)])
    return ref.fused_stats_ref(x, y)


# the reference's name for the flat hot-path call (one bucket of g_j and
# g); the kernel's grid covers whatever buffer arrives
stats_flat = fused_stats


def stats_flat_buckets(xs, ys):
    """(Σ_i Σ(x_i−y_i)², Σ_i Σy_i²) over every bucket pair of the lists, as
    two 0-d f32 tensors: one `fused_stats` launch per dtype group on the
    card; on the CPU the plain version bucket by bucket, summed in bucket
    order."""
    if xs and _on_card("stats_flat_buckets", xs[0]):
        return _fs.fused_stats_buckets(xs, ys)
    _note("fused_stats", list(zip(xs, ys)))
    device = xs[0].device if xs else "cpu"
    dsq = torch.zeros((), dtype=torch.float32, device=device)
    ysq = torch.zeros((), dtype=torch.float32, device=device)
    for x, y in zip(xs, ys):
        d, q = ref.fused_stats_ref(x, y)
        dsq = dsq + d
        ysq = ysq + q
    return dsq, ysq


def fused_adamw(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1, c2):
    """AdamW on one tensor, IN PLACE on p, m and v (the reference step
    donates them); no clip.  Returns (p, m, v)."""
    if _on_card("fused_adamw", p):
        return _fa.fused_adamw(p, g, m, v, (lr, c1, c2, 1.0), beta1=beta1,
                               beta2=beta2, eps=eps, weight_decay=weight_decay)
    _note("fused_adamw", [(p, g, m, v)])
    return _adamw_plain(p, g, m, v, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay, c1=c1, c2=c2)


def _adamw_plain(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1, c2):
    p2, m2, v2 = ref.adamw_ref(p, g, m, v, lr=lr, beta1=beta1, beta2=beta2,
                               eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v


def fused_adamw_tree(params, grads, m, v, *, lr, beta1, beta2, eps,
                     weight_decay, c1, c2):
    """`fused_adamw` over every leaf, in place; returns the (params, m, v)
    trees, whose leaves are the tensors passed in.  On the card the
    scalars go up once and one `fused_adamw` launch per dtype group of
    (p, g) takes every leaf; on the CPU the plain version leaf by leaf."""
    leaves = [tree_leaves(t) for t in (params, grads, m, v)]
    if leaves[0] and _on_card("fused_adamw_tree", leaves[0][0]):
        _fa.fused_adamw_buckets(*leaves, (lr, c1, c2, 1.0), beta1=beta1,
                                beta2=beta2, eps=eps, weight_decay=weight_decay)
        return params, m, v
    _note("fused_adamw", list(zip(*leaves)))
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, c1=c1, c2=c2)
    for xs in zip(*leaves, strict=True):
        _adamw_plain(*xs, **kw)
    return params, m, v


def adamw_flat(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1, c2,
               clip_scale=1.0):
    """Flat-buffer AdamW over one bucket, IN PLACE on p, m and v (the port's
    form of the reference's buffer donation).  Returns (p, m, v, Σg²_raw)
    with Σg² a 0-d f32 tensor on p's device."""
    if _on_card("adamw_flat", p):
        gsq = _fa.fused_adamw_stats(
            p, g, m, v, (lr, c1, c2, clip_scale), beta1=beta1, beta2=beta2,
            eps=eps, weight_decay=weight_decay)
        return p, m, v, gsq
    _note("fused_adamw_stats", [(p, g, m, v)])
    return _adamw_flat_plain(p, g, m, v, lr=lr, beta1=beta1, beta2=beta2,
                             eps=eps, weight_decay=weight_decay, c1=c1, c2=c2,
                             clip_scale=clip_scale)


def _adamw_flat_plain(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1,
                      c2, clip_scale):
    p2, m2, v2, gsq = ref.adamw_stats_ref(
        p, g, m, v, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, c1=c1, c2=c2, clip_scale=clip_scale)
    p.copy_(p2)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v, gsq


def adamw_flat_buckets(pb, gb, mb, vb, *, lr, beta1, beta2, eps, weight_decay,
                       c1, c2, clip_scale=1.0):
    """`adamw_flat` over every bucket (p_i, g_i, m_i, v_i) of the lists, IN
    PLACE; returns Σg²_raw over all of them as a 0-d f32 tensor.  On the
    card one `fused_adamw_stats` launch per dtype group of (p, g); on the
    CPU the plain version bucket by bucket, summed in bucket order."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if pb and _on_card("adamw_flat_buckets", pb[0]):
        return _fa.fused_adamw_stats_buckets(pb, gb, mb, vb,
                                             (lr, c1, c2, clip_scale), **kw)
    _note("fused_adamw_stats", list(zip(pb, gb, mb, vb)))
    gsq = torch.zeros((), dtype=torch.float32,
                      device=pb[0].device if pb else "cpu")
    for p, g, m, v in zip(pb, gb, mb, vb):
        gsq = gsq + _adamw_flat_plain(p, g, m, v, lr=lr, c1=c1, c2=c2,
                                      clip_scale=clip_scale, **kw)[3]
    return gsq


def rmsnorm(x, scale, eps: float = 1e-6, *, plain=None):
    """Row-wise RMSNorm over the last axis; the result has x's dtype.  On
    the CPU, `plain()` where the caller gives its own plain code (the
    model's, so that a forward routed through here computes on the CPU
    what it always did), else `ref.rmsnorm_ref`."""
    if _on_card("rmsnorm", x):
        return _rmsnorm(x, scale, eps)
    _note("rmsnorm", [(x,)])
    return plain() if plain is not None else ref.rmsnorm_ref(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, plain=None):
    """Attention of q (b, t, h, d) over k, v (b, s, kvh, d) with GQA, the
    causal mask top-left aligned; the result has q's dtype.  On the CPU,
    `plain()` where the caller gives it (as for `rmsnorm`), else
    `ref.flash_attention_ref`."""
    if _on_card("flash_attention", q):
        return _flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    _note("flash_attention", [(q,)])
    if plain is not None:
        return plain()
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)


@functools.cache
def _dense_plan(eq: str) -> tuple:
    """(contracted dims, w K-major) of an einsum `eq` that contracts x's
    trailing dims with w's leading dims (w stored (K, ...), N-major) or
    with its trailing dims (the head's (v, d) table, K-major), the output
    being x's free dims, then w's."""
    ins, out = eq.replace("...", "").split("->")
    xs, ws = ins.split(",")
    n = sum(ch in ws for ch in xs)
    tail = xs[len(xs) - n:]
    if n and all(ch not in out for ch in tail):
        if ws[:n] == tail and out == xs[:-n] + ws[n:]:
            return n, False
        if ws[len(ws) - n:] == tail and out == xs[:-n] + ws[:-n]:
            return n, True
    raise ValueError(f"dense: {eq!r} is not a product against a weight")


def _dense_routed(x, w, rows: int) -> bool:
    """The kernel's rule, read off the operands: both float32 on the card
    and at least one wgmma row tile of rows, outside a `torch.func`
    transform (`Dense` has no vmap rule: per-sample gradients keep the
    einsum)."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and w.dtype == torch.float32 and rows >= _dense.MIN_ROWS
            and not torch._C._are_functorch_transforms_active())


def dense(eq: str, x, w):
    """`torch.einsum(eq, x, w)` for x against a weight w (`_dense_plan`).
    Both float32 on the card with at least `MIN_ROWS` rows (x's free dims):
    the split-TF32 kernel through `Dense`, whose backward launches it for
    dX and dW; otherwise the einsum."""
    kdims, w_kmajor = _dense_plan(eq)
    k = math.prod(x.shape[x.dim() - kdims:])
    rows = x.numel() // k if k else 0
    if _dense_routed(x, w, rows):
        w2 = w.reshape(-1, k).t() if w_kmajor else w.reshape(k, -1)
        free = w.shape[:w.dim() - kdims] if w_kmajor else w.shape[kdims:]
        y = _dense.Dense.apply(x.reshape(rows, k), w2)
        return y.view(*x.shape[:x.dim() - kdims], *free)
    _PLAIN_CALLS["dense"] += 1
    return torch.einsum(eq, x, w)


def flat_dispatch_info(device) -> dict:
    """Which implementation the flat hot path (the statistics pair and the
    AdamW tail) runs for tensors on `device`."""
    kind = torch.device(device).type
    route = lambda kernel: {"cuda": f"cuda-kernel {kernel}",
                            "cpu": "torch-reference"}.get(kind, "unsupported")
    return {"device": str(device), "stats_flat": route("fused_stats"),
            "flat_tail": route("fused_adamw_stats")}


# the calls above that ran a plain version (off the card), each counted as
# the launches the card would make for it (one per dtype group of a list
# call; a `dense` call that took the einsum counts once)
_PLAIN_CALLS = {}


def _note(kernel: str, buckets):
    _PLAIN_CALLS[kernel] += launches(buckets)


def call_counts() -> dict:
    """Each kernel's calls in this process, as launches on the card,
    whatever device the tensors lay on: the wrappers' launches (a fake
    call's included) and the plain versions' calls (a graph replay is no
    call).  What a trace reads (`launch/dryrun.py`), as a difference."""
    return {name: fn.launches + _PLAIN_CALLS[name] for name, fn in _COUNTED.items()}


_COUNTED = {"fused_adamw_stats": _fa.fused_adamw_stats,
            "fused_adamw": _fa.fused_adamw, "fused_stats": _fs.fused_stats,
            "sqdiff_norm": _sqdiff_norm, "rmsnorm": _rmsnorm,
            "flash_attention": _flash_attention, "dense": _dense.dense_mm}


_PLAIN_CALLS.update({name: 0 for name in _COUNTED})

# launches made by replaying captured CUDA graphs (`CountedGraph`): a
# replay runs the kernels its capture recorded without calling a wrapper
_REPLAYED = {name: 0 for name in _COUNTED}


def launch_counts() -> dict:
    """Each kernel's launches in this process: its wrapper's calls outside
    a capture, plus every graph replay's captured launches."""
    return {name: fn.launches + _REPLAYED[name] for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for name, fn in _COUNTED.items():
        fn.launches = 0
        _REPLAYED[name] = 0


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph capture: the wrappers called inside record
    launches, they do not make them, so their counts are taken back out
    and yielded (a dict filled on exit) for the `CountedGraph` to add at
    each replay.  No other thread may launch a counted kernel meanwhile."""
    before = {name: fn.launches for name, fn in _COUNTED.items()}
    captured = {}
    try:
        yield captured
    finally:
        for name, fn in _COUNTED.items():
            captured[name] = fn.launches - before[name]
            fn.launches = before[name]


class CountedGraph:
    """A captured graph (anything with `replay()`: a `torch.cuda.CUDAGraph`
    on the card) and the kernel launches its capture recorded; each
    `replay` adds them to `launch_counts()`."""

    def __init__(self, graph, captured: dict):
        self.graph = graph
        self.captured = {k: n for k, n in captured.items() if n}

    def replay(self):
        self.graph.replay()
        for name, n in self.captured.items():
            _REPLAYED[name] += n
