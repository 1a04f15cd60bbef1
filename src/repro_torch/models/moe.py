"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch,
shared experts (DeepSeek-V2), switch-style load-balance aux loss —
counterpart of `repro/models/moe.py`.

Dispatch groups are batch rows, as in the reference: each row sorts its
token-expert pairs by expert id (stable), keeps the first `capacity` pairs
of every expert, gathers them into an (E, C, d) tensor and runs the
experts as one batched einsum.  Pairs over capacity are dropped.

Every data movement is a GATHER with a fixed summation order, so a
gradient is the same bits at any thread count and in every process (the
bit-exact resume of DESIGN §12 and the common rung proposal of DESIGN §14
need that):

* dispatch: `F.embedding` of the padded token rows by the slot -> token
  map (its backward adds each token's slot gradients in slot order; an
  advanced-index gather would backpropagate through an accumulating
  `index_put_`, which adds with float atomics);
* combine: each token gathers its <= top_k slot outputs and sums them in
  k order, where the reference scatter-adds slot outputs into token rows.

A dropped pair writes nowhere.  The reference routes it to slot index
n·k, which is a real slot whenever E·C > n·k (capacity factor above 1),
so there a dropped pair can overwrite a kept one (ROADMAP §3); at a
capacity factor of at most 1, and whenever nothing drops, the two
dispatches are equal.

Tensor parallelism (`distributed/sharding.py`): when `w_gate` holds fewer
experts than the config's, the rank holds experts [m·E/M, (m+1)·E/M), and
the router is whole on every rank.  Every rank routes every token the
same way and runs its own experts' slots; a pair whose expert lives on
another rank reads the zero row, so the rank's combine is its partial sum,
made whole at the reference's exit (`maybe_shard`).  Two gradients meet in
the router: the gates' through this rank's slots only (partial), the aux
loss's whole on every rank.  The gates enter through `tp_enter`, so their
gradient is summed over the group before it reaches the router, whose
gradient then comes out whole ("replicated"); likewise x reaches the
router as it is, and the experts through `tp_enter`.  DeepSeek-V2's shared
experts are a dense SwiGLU: column/row parallel when their leaves are
slices, their partial sum joining the experts' before the one exit.

Under sequence parallelism (training) the router, the per-row capacity
dispatch and the aux loss need every token of a row: x is all-gathered
whole first (`stream_gather`: the gradient reaching it is the same on
every rank, the router's whole and the experts' summed by `tp_enter`),
and the exit reduce-scatters into this rank's slice of the stream; a
whole part added after the exit is cut to that slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, stream_gather, stream_scatter, tp_enter)
from repro_torch.models.common import normal_init
from repro_torch.models.config import MoEConfig


def init_moe(gen, d_model: int, m: MoEConfig, dtype, device):
    e, f = m.num_experts, m.d_expert
    p = {
        "router": normal_init(gen, (d_model, e), dtype, device),
        "w_gate": normal_init(gen, (e, d_model, f), dtype, device),
        "w_up": normal_init(gen, (e, d_model, f), dtype, device),
        "w_down": normal_init(gen, (e, f, d_model), dtype, device),
    }
    if m.num_shared_experts:
        width = m.num_shared_experts * m.shared_d_expert
        p["shared"] = {
            "w_gate": normal_init(gen, (d_model, width), dtype, device),
            "w_up": normal_init(gen, (d_model, width), dtype, device),
            "w_down": normal_init(gen, (width, d_model), dtype, device),
        }
    return p


def _capacity(num_tokens: int, m: MoEConfig, capacity_factor: float) -> int:
    c = int(capacity_factor * num_tokens * m.top_k / m.num_experts)
    return max(min(c, num_tokens), 1)


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, ties to
    the lower index (`lax.top_k`'s order): a stable descending sort."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return probs.gather(-1, idx), idx


def route(params, x, m: MoEConfig, capacity_factor: float,
          normalize_gates: bool = True, enter_gates: bool = False):
    """Routing and dispatch of every row of x (b, n, d).

    Returns a dict: `slot_token` (b, E, C) int64, the token each expert slot
    holds (n for an empty slot); `slot_gate` (b, E, C), its gate in x's
    dtype (0 for an empty slot); `pair_slot` (b, n, k) int64, the flat slot
    e·C + c each token's j-th choice landed in (E·C when dropped); `aux`
    (b,) f32, each row's load-balance loss.  `enter_gates`: the gates pass
    `tp_enter` (their gradient summed over the model group)."""
    b, n, _ = x.shape
    dt, dev = x.dtype, x.device
    e, k = m.num_experts, m.top_k
    logits = torch.einsum("bnd,de->bne", x, params["router"].to(dt))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, expert_idx = _top_k(probs, k)                       # (b, n, k)
    if normalize_gates:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    if enter_gates:
        gates = tp_enter(gates)

    # switch-style load balance loss over all-k assignments
    frac_tokens = F.one_hot(expert_idx, e).sum(2).float().mean(1)   # (b, E)
    frac_probs = probs.mean(1)                                      # (b, E)
    aux = e * (frac_tokens * frac_probs).sum(-1) * m.router_aux_coef

    # sort-based capacity dispatch; pair p = t·k + j
    cap = _capacity(n, m, capacity_factor)
    nk, n_slots = n * k, e * cap
    pair_expert = expert_idx.reshape(b, nk)
    order = torch.argsort(pair_expert, dim=-1, stable=True)
    se = pair_expert.gather(1, order)
    sg = gates.reshape(b, nk).to(dt).gather(1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(se, experts)                        # (b, E)
    pos = torch.arange(nk, device=dev) - starts.gather(1, se)
    keep = pos < cap
    # a dropped pair goes to a slot of its own past the E·C real ones, so
    # every index is written once
    dest = torch.where(keep, se * cap + pos, n_slots + torch.arange(nk, device=dev))
    slot_token = torch.full((b, n_slots + nk), n, dtype=torch.long, device=dev)
    slot_token = slot_token.scatter(1, dest, order // k)[:, :n_slots]
    slot_gate = torch.zeros((b, n_slots + nk), dtype=dt, device=dev)
    slot_gate = slot_gate.scatter(1, dest, torch.where(keep, sg, 0))[:, :n_slots]
    pair_slot = torch.empty_like(dest).scatter(1, order, dest.clamp(max=n_slots))
    return {"slot_token": slot_token.view(b, e, cap),
            "slot_gate": slot_gate.view(b, e, cap),
            "pair_slot": pair_slot.view(b, n, k), "aux": aux}


def _gather_rows(src, idx):
    """src (b, r, d), idx (b, ...) into [0, r) -> (b, ..., d), through
    `F.embedding` over the flattened rows (a deterministic backward)."""
    b, r, d = src.shape
    rows = idx + (torch.arange(b, device=idx.device) * r).view(
        (b,) + (1,) * (idx.dim() - 1))
    return F.embedding(rows, src.reshape(b * r, d))


def _swiglu(p, x):
    dt = x.dtype
    h = F.silu(torch.einsum("bnd,df->bnf", x, p["w_gate"].to(dt)))
    h = h * torch.einsum("bnd,df->bnf", x, p["w_up"].to(dt))
    return torch.einsum("bnf,fd->bnd", h, p["w_down"].to(dt))


def moe_apply(params, x, m: MoEConfig, *, capacity_factor: float | None = None,
              normalize_gates: bool = True):
    """x: (b, t, d) -> (out, aux_loss): every row is one dispatch group,
    capacity C = factor·t·top_k/E per row; aux is the mean over rows.
    Expert and shared leaves that are this rank's slices run tensor-parallel
    (module docstring)."""
    x = stream_gather(x)
    b, n, d = x.shape
    dt = x.dtype
    tp = model_axis()
    e_loc = params["w_gate"].shape[0]
    experts_tp = tp is not None and e_loc != m.num_experts
    shared_tp = (tp is not None and "shared" in params and params["shared"]["w_up"].shape[1]
                 != m.num_shared_experts * m.shared_d_expert)
    x_tp = tp_enter(x) if experts_tp or shared_tp else x
    r = route(params, x, m, capacity_factor if capacity_factor is not None
              else m.capacity_factor, normalize_gates, enter_gates=experts_tp)
    # this rank's experts' slots; pairs outside them read the zero row
    e0 = tp[1] * e_loc if experts_tp else 0
    cap = r["slot_token"].shape[-1]
    n_loc = e_loc * cap
    pair_slot = r["pair_slot"] - e0 * cap
    pair_slot = torch.where((pair_slot >= 0) & (pair_slot < n_loc), pair_slot, n_loc)
    zero_row = torch.zeros((b, 1, d), dtype=dt, device=x.device)
    xe = x_tp if experts_tp else x
    edx = _gather_rows(torch.cat([xe, zero_row], 1),
                       r["slot_token"][:, e0:e0 + e_loc])               # (b,E,C,d)
    h = F.silu(torch.einsum("becd,edf->becf", edx, params["w_gate"].to(dt)))
    h = h * torch.einsum("becd,edf->becf", edx, params["w_up"].to(dt))
    eout = torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))
    contrib = (eout * r["slot_gate"][:, e0:e0 + e_loc, :, None]).reshape(b, -1, d)
    parts = _gather_rows(torch.cat([contrib, zero_row], 1), pair_slot)
    y = parts[:, :, 0]
    for j in range(1, m.top_k):       # each token's slots, in k order
        y = y + parts[:, :, j]

    whole = None                      # a whole part, added after the exit
    if "shared" in params:
        ys = _swiglu(params["shared"], x_tp if shared_tp else x)
        if shared_tp == experts_tp:
            y = y + ys
        elif experts_tp:
            whole = ys
        else:
            y, whole = ys, y
    if experts_tp or shared_tp:
        y = maybe_shard(y, "batch", "seq", "embed")
    else:
        y = stream_scatter(y)
    if whole is not None:
        y = y + stream_scatter(whole)
    return y, r["aux"].mean()
