"""RecurrentGemma / Griffin RG-LRU recurrent block [arXiv:2402.19427] —
counterpart of `repro/models/rglru.py`.

Block: two branches from d_model -> lru_width; branch A goes through GeLU,
branch B through a causal depthwise conv1d then the RG-LRU recurrence; the
branches are multiplied and projected back to d_model.

RG-LRU:  r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x)
         a_t = exp(-c * softplus(Lambda) * r_t)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the recurrence as `jax.lax.associative_scan`; here it is
a log-depth (Hillis-Steele) scan on whole tensors, ceil(log2 t) steps of a
few elementwise operations each, not a t-step loop (8192 steps would be
some 40 000 launches a layer on the card).  Decode is one recurrence step
with a convolution ring; it writes the new state into the cache's tensors
IN PLACE (the reference returns new arrays).

Tensor parallelism (`distributed/sharding.py`): when `w_branch_b` holds
fewer columns than the lru width, the rank holds its columns [m·w/M,
(m+1)·w/M) of `w_branch_a`, `w_branch_b`, `conv_w`, `w_rg` and `w_ig` (the
gates' output columns) and its rows of `w_out`.  x enters through
`tp_enter`; the branches, the depthwise conv and the scan run on the
rank's columns; the gates' products need the whole conv output u, which is
all-gathered (`tp_gather` behind `tp_enter`: its gradient summed over the
group, then the rank's slice).  `w_out`'s partial sum is made whole at the
exit (`maybe_shard`).  `conv_b`, `b_rg`, `b_ig` and `lam` are whole (w,)
vectors that the rank applies to its own columns only, so each rank's
gradient of them is zero off its columns: "partial", summed over the model
group by the step (`params.model_roles`).  Decode runs the same split on
one token, its `h` and `conv` state the rank's columns (`cache_pspecs`).
Under sequence parallelism (training) x enters through `stream_enter`
(the conv and the scan see the whole sequence) and the exit
reduce-scatters into this rank's slice of the stream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, stream_enter, stream_gather, stream_scatter,
    tp_enter, tp_gather)
from repro_torch.models.common import normal_init, zeros_init
from repro_torch.models.config import RGLRUConfig


def init_rglru(gen, d_model: int, r: RGLRUConfig, dtype, device):
    w = r.lru_width or d_model
    return {
        "w_branch_a": normal_init(gen, (d_model, w), dtype, device),
        "w_branch_b": normal_init(gen, (d_model, w), dtype, device),
        "conv_w": normal_init(gen, (r.conv_width, w), dtype, device),
        "conv_b": zeros_init((w,), dtype, device),
        "w_rg": normal_init(gen, (w, w), dtype, device, stddev=0.02),
        "b_rg": zeros_init((w,), dtype, device),
        "w_ig": normal_init(gen, (w, w), dtype, device, stddev=0.02),
        "b_ig": zeros_init((w,), dtype, device),
        # Lambda: f32 whatever the dtype, as in the reference
        "lam": normal_init(gen, (w,), torch.float32, device, stddev=0.5),
        "w_out": normal_init(gen, (w, d_model), dtype, device),
    }


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (b, t, w); w: (k, w)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _gates(params, x, c_constant, x_in=None, cols=slice(None)):
    """(a, gated input) of the columns `cols` of x; the gates' products
    take `x_in` (default x), whose columns are all of the width."""
    x_in = x if x_in is None else x_in
    r = torch.sigmoid(torch.einsum("btw,wv->btv", x_in, params["w_rg"].to(x.dtype))
                      + params["b_rg"][cols].to(x.dtype))
    i = torch.sigmoid(torch.einsum("btw,wv->btv", x_in, params["w_ig"].to(x.dtype))
                      + params["b_ig"][cols].to(x.dtype))
    log_a = -c_constant * F.softplus(params["lam"][cols])[None, None, :] * r.float()
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (
        i.float() * x.float())
    return a, gated_in


def rglru_scan(a, bx):
    """h_t = a_t h_{t-1} + bx_t over dim 1 (h_{-1} = 0), by a log-depth
    scan: after the step of offset o, (a_t, bx_t) composes the steps
    t-2o+1 .. t, so ceil(log2 t) steps compose them all."""
    t = a.shape[1]
    o = 1
    while o < t:
        bx = torch.cat([bx[:, :o], a[:, o:] * bx[:, :-o] + bx[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return bx


def rglru_block(params, x, r: RGLRUConfig):
    """Full-sequence RG-LRU block.  x: (b, t, d) -> (b, t, d); leaves with
    fewer columns than the lru width run tensor-parallel (module
    docstring)."""
    tp = model_axis()
    w = params["w_branch_b"].shape[1]
    tp = tp if tp is not None and w != (r.lru_width or x.shape[-1]) else None
    cols = slice(None) if tp is None else slice(tp[1] * w, (tp[1] + 1) * w)
    x = stream_gather(x) if tp is None else stream_enter(x)
    branch_a = _gelu(torch.einsum("btd,dw->btw", x, params["w_branch_a"].to(x.dtype)))
    u = torch.einsum("btd,dw->btw", x, params["w_branch_b"].to(x.dtype))
    u = _causal_conv(u, params["conv_w"].to(x.dtype), params["conv_b"][cols].to(x.dtype))
    a, bx = _gates(params, u, r.c_constant,
                   x_in=None if tp is None else tp_enter(tp_gather(u, -1)), cols=cols)
    h = rglru_scan(a, bx).to(x.dtype)
    out = torch.einsum("btw,wd->btd", branch_a * h, params["w_out"].to(x.dtype))
    return (stream_scatter(out) if tp is None
            else maybe_shard(out, "batch", "seq", "embed"))


def init_rglru_state(batch: int, d_model: int, r: RGLRUConfig, dtype, device):
    w = r.lru_width or d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, r.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_decode(params, x, state, r: RGLRUConfig):
    """Single-token step.  x: (b, 1, d).  `state`'s tensors are updated in
    place; with leaves of fewer columns than the lru width they are the
    rank's columns (module docstring).  Returns (out, state)."""
    tp = model_axis()
    w = params["w_branch_b"].shape[1]
    tp = tp if tp is not None and w != (r.lru_width or x.shape[-1]) else None
    cols = slice(None) if tp is None else slice(tp[1] * w, (tp[1] + 1) * w)
    if tp is not None:
        x = tp_enter(x)
    branch_a = _gelu(torch.einsum("btd,dw->btw", x, params["w_branch_a"].to(x.dtype)))
    u = torch.einsum("btd,dw->btw", x, params["w_branch_b"].to(x.dtype))
    conv_in = torch.cat([state["conv"].to(x.dtype), u], dim=1)           # (b, k, w)
    u_conv = (torch.einsum("bkw,kw->bw", conv_in, params["conv_w"].to(x.dtype))
              + params["conv_b"][cols].to(x.dtype))[:, None, :]
    a, bx = _gates(params, u_conv, r.c_constant,
                   x_in=None if tp is None else tp_gather(u_conv, -1), cols=cols)
    h = a[:, 0] * state["h"] + bx[:, 0]
    y = branch_a[:, 0] * h.to(x.dtype)
    out = torch.einsum("bw,wd->bd", y, params["w_out"].to(x.dtype))[:, None, :]
    if tp is not None:
        out = maybe_shard(out, "batch", "seq", "embed")
    state["h"].copy_(h)
    state["conv"].copy_(conv_in[:, 1:, :])
    return out, state
