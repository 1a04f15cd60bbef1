"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] — counterpart
of `repro/models/ssd.py`.

Training and prefill use the chunked dual form: within a chunk the
recurrence is materialized as masked matrix products; across chunks a
short loop carries the (heads, state, head_dim) SSM state — t / chunk
sequential steps instead of t.  Decode is the exact one-step recurrence.
The reference computes both in jnp, not in a Pallas kernel, so here they
are plain PyTorch; the f32 islands (the decay, the scan, the gated norm)
are the reference's.

Decode writes the new SSM and convolution state into the cache's tensors
IN PLACE (the reference returns new arrays), so a cache whose tensors are
views of a resident slot buffer updates that buffer.

Tensor parallelism (`distributed/sharding.py`) keeps the reference's
layout: `w_in` is cut by its output columns, across the fused [z | x | B |
C | dt] projection (the cut need not fall at a head), `conv_w` by its
channels across x | B | C, `w_out` by its rows; `conv_b`, `a_log`,
`dt_bias`, `d_skip` and `norm_scale` are whole.  The block gathers the
three cut leaves whole (`tp_gather`, whose backward takes the rank's slice
of a gradient every rank computes the same) and runs whole on every rank,
so it computes what one process does, to the bit: its gradients of the
whole leaves are whole on every rank ("replicated"), the cut leaves' the
rank's slices ("sharded"), and no activation crosses the model group.
Right rather than fast: each rank repeats the block's work.  Under
sequence parallelism (training) the chunked scan needs the whole
sequence: the stream's slices are all-gathered at the block's entry
(`stream_gather`) and the rank keeps its slice of the output
(`stream_scatter`).  Splitting
the work instead (the projection's columns gathered, y's rows through
`w_out` summed at the exit) rounds the projection in another order, and
the scan's decay gradients, sums with much cancellation over a sequence,
then missed 1e-5 of the whole layer's on the card at full width.

Decode, forward only, keeps the state in `cache_pspecs`'s layout (`ssm`
over heads, `conv` over channels) and computes on the rank's part: the
projection's columns all-gathered whole (a few thousand numbers a row),
the depthwise convolution on the rank's channels and the recurrence on its
heads, each all-gathered for the gated norm, which needs every head; the
rank's rows of `w_out` then give a partial sum made whole at the exit
(`maybe_shard`).  Gathering the cut leaves and the state instead, as the
block does, would move megabytes a layer and a step through the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, stream_gather, stream_scatter, tp_gather)
from repro_torch.models.common import normal_init, ones_init, zeros_init
from repro_torch.models.config import SSMConfig


def init_ssd(gen, d_model: int, s: SSMConfig, dtype, device):
    di = s.d_inner(d_model)
    nh = s.num_heads(d_model)
    conv_ch = di + 2 * s.state_dim          # conv over [x, B, C]
    return {
        # fused input projection -> [z, x, B, C, dt]
        "w_in": normal_init(gen, (d_model, 2 * di + 2 * s.state_dim + nh), dtype,
                            device),
        "conv_w": normal_init(gen, (s.conv_width, conv_ch), dtype, device),
        "conv_b": zeros_init((conv_ch,), dtype, device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "dt_bias": zeros_init((nh,), torch.float32, device),
        "d_skip": ones_init((nh,), torch.float32, device),
        "norm_scale": ones_init((di,), dtype, device),
        "w_out": normal_init(gen, (di, d_model), dtype, device),
    }


def _whole(w, dim: int, size: int):
    """Leaf `w` whole: on a model axis, this rank's slice along `dim`
    gathered to `size`."""
    return tp_gather(w, dim) if w.shape[dim] != size and model_axis() is not None else w


def _split_proj(params, x, s: SSMConfig, d_model: int):
    di = s.d_inner(d_model)
    nh = s.num_heads(d_model)
    w_in = _whole(params["w_in"], 1, 2 * di + 2 * s.state_dim + nh)
    proj = torch.einsum("btd,dp->btp", x, w_in.to(x.dtype))
    z, xbc, dt = torch.split(proj, [di, di + 2 * s.state_dim, nh], dim=-1)
    return z, xbc, dt, di, nh


def _causal_conv(x, w, b):
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def _gated_norm(params, y, z, x_dtype):
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return (y / torch.sqrt(var + 1e-6) * params["norm_scale"].float()).to(x_dtype)


def _gated_out(params, y, z, x_dtype):
    y = _gated_norm(params, y, z, x_dtype)
    w_out = _whole(params["w_out"], 0, y.shape[-1])
    return torch.einsum("btf,fd->btd", y, w_out.to(x_dtype))


def ssd_block(params, x, s: SSMConfig):
    """Chunked SSD over a full sequence.  x: (b, t, d); t must be a multiple
    of `s.chunk_size`, as in the reference."""
    x = stream_gather(x)
    b, t, d_model = x.shape
    z, xbc, dt_raw, di, nh = _split_proj(params, x, s, d_model)
    conv_w = _whole(params["conv_w"], 1, xbc.shape[-1])
    xbc = _causal_conv(xbc, conv_w.to(x.dtype), params["conv_b"].to(x.dtype))
    xs, B, C = torch.split(xbc, [di, s.state_dim, s.state_dim], dim=-1)
    p = s.head_dim
    xs = xs.reshape(b, t, nh, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])   # (b,t,nh)
    a = -torch.exp(params["a_log"])                                       # (nh,)
    dA = dt * a[None, None, :]                                            # log decay

    q = s.chunk_size
    if t % q:
        raise ValueError(f"seq {t} must be divisible by chunk {q}")
    nc = t // q
    xs_c = xs.reshape(b, nc, q, nh, p).float()
    B_c = B.reshape(b, nc, q, s.state_dim).float()
    C_c = C.reshape(b, nc, q, s.state_dim).float()
    dt_c = dt.reshape(b, nc, q, nh)
    dA_c = dA.reshape(b, nc, q, nh)

    cum = torch.cumsum(dA_c, dim=2)                                       # (b,nc,q,nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                   # (b,nc,i,j,nh)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: non-causal entries have a positive log-decay, whose
    # exp overflows, and 0 * inf = NaN in the backward pass
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.tensor(-1e30, device=x.device))
    decay = torch.exp(seg)

    # intra-chunk: y[i] = sum_j<=i (C_i . B_j) decay(i,j) dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)                        # (b,nc,q,q)
    m = cb[..., None] * decay * dt_c[:, :, None, :, :]                    # (b,nc,i,j,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xs_c)

    # chunk state contributions: S_c = sum_j exp(cum[-1]-cum[j]) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)                     # (b,nc,q,nh)
    wb = (decay_to_end * dt_c)[..., None] * B_c[:, :, :, None, :]         # (b,nc,j,nh,n)
    sc = torch.einsum("bcjhn,bcjhp->bchnp", wb, xs_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])                             # (b,nc,nh)

    # the loop over chunks carries the state (b, nh, n, p); each chunk reads
    # the state from before it
    state = torch.zeros((b, nh, s.state_dim, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    prev_states = torch.stack(prev, dim=1)                                # (b,nc,nh,n,p)

    # inter-chunk: y[i] += C_i . (decay_from_start(i) * S_prev)
    decay_from_start = torch.exp(cum)                                     # (b,nc,q,nh)
    y_inter = torch.einsum("bcin,bchnp->bcihp", C_c, prev_states) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(b, t, nh, p)
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    return stream_scatter(_gated_out(params, y.reshape(b, t, di), z, x.dtype))


def init_ssd_state(batch: int, d_model: int, s: SSMConfig, dtype, device):
    nh = s.num_heads(d_model)
    di = s.d_inner(d_model)
    return {
        "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * s.state_dim),
                            dtype=dtype, device=device),
    }


def _rank_part(n_local: int, n: int):
    """The slice of [0, n) this rank holds when it holds `n_local` of them
    (all of them when n_local == n)."""
    tp = model_axis()
    if n_local == n or tp is None:
        return slice(None)
    return slice(tp[1] * n_local, (tp[1] + 1) * n_local)


def ssd_decode(params, x, state, s: SSMConfig):
    """Exact single-step recurrence.  x: (b, 1, d).  `state`'s tensors are
    updated in place; on a model axis they are this rank's heads and
    channels (module docstring).  Returns (out, state)."""
    b, _, d_model = x.shape
    di = s.d_inner(d_model)
    nh = s.num_heads(d_model)
    conv_ch = di + 2 * s.state_dim
    proj = torch.einsum("btd,dp->btp", x, params["w_in"].to(x.dtype))
    if proj.shape[-1] != 2 * di + 2 * s.state_dim + nh:
        proj = tp_gather(proj, -1)
    z, xbc, dt_raw = torch.split(proj, [di, conv_ch, nh], dim=-1)
    ch = _rank_part(state["conv"].shape[-1], conv_ch)
    conv_in = torch.cat([state["conv"].to(x.dtype), xbc[..., ch]], dim=1)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", conv_in, params["conv_w"].to(x.dtype))
                   + params["conv_b"][ch].to(x.dtype))
    if ch != slice(None):
        xbc_t = tp_gather(xbc_t, -1)
    xs, B, C = torch.split(xbc_t, [di, s.state_dim, s.state_dim], dim=-1)
    p = s.head_dim
    xs = xs.reshape(b, nh, p).float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][None, :])   # (b,nh)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a[None, :])                                   # (b,nh)
    hs = _rank_part(state["ssm"].shape[1], nh)
    new_state = state["ssm"] * decay[:, hs, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt[:, hs], B.float(), xs[:, hs])
    y = torch.einsum("bn,bhnp->bhp", C.float(), new_state)
    y = y + params["d_skip"][hs][None, :, None] * xs[:, hs]
    if hs != slice(None):
        y = tp_gather(y, 1)
    y = _gated_norm(params, y.reshape(b, 1, di), z, x.dtype)
    rows = _rank_part(params["w_out"].shape[0], di)
    out = torch.einsum("btf,fd->btd", y[..., rows], params["w_out"].to(x.dtype))
    if rows != slice(None):
        out = maybe_shard(out, "batch", "seq", "embed")
    state["ssm"].copy_(new_state)
    state["conv"].copy_(conv_in[:, 1:, :])
    return out, state
