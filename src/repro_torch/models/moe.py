"""Mixture-of-Experts layer: top-k or group-limited greedy routing,
sort-based capacity dispatch, shared experts (DeepSeek-V2), the
load-balance aux losses — counterpart of `repro/models/moe.py`.

Routing (`route`): the router scores every expert a token can be sent to
(`MoEConfig.num_routed`, the published count, whether or not they are held
here); a softmax over them; the top_k, or with `n_group` > 1 DeepSeek-V2's
group-limited greedy choice (the `topk_group` groups of highest maximum
score, then the top_k experts inside them; ties to the lower index); the
gates divided by their sum unless `norm_topk_prob` is off, then times
`routed_scaling_factor`.  The aux loss is the switch-style expert term
over the router's width, plus DeepSeek-V2's device- and
communication-level terms over the groups when their coefficients are set.

Dispatch groups are batch rows, as in the reference: each row sorts its
token-expert pairs by expert id (stable), keeps the first `capacity` pairs
of every expert, C = factor·t·top_k / num_routed, gathers them into an
(E, C, d) tensor and runs the experts as one batched einsum.  Pairs over
capacity are dropped.

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

Held experts.  `w_gate`, `w_up` and `w_down` hold the experts
[first_expert, first_expert + num_experts) of the router's num_routed:
one expert-parallel rank's share, on one card with no exchange.  Every
token is routed over all of them; the layer runs its own experts' slots,
and a pair whose expert is held elsewhere reads the zero row, so the
combine is this share's partial sum, which goes on to the next layer as
it is.  The shared experts and the aux loss are whole.

Tensor parallelism (`distributed/sharding.py`): when `w_gate` holds fewer
experts than the config's num_experts, the rank holds the held range's
experts [m·E/M, (m+1)·E/M), and the router is whole on every rank, as
above; the rank's combine is its partial sum, made whole at the
reference's exit (`maybe_shard`).  Two gradients meet in the router: the
gates' through this rank's slots only (partial), the aux loss's whole on
every rank.  The gates enter through `tp_enter`, so their gradient is
summed over the group before it reaches the router, whose gradient then
comes out whole ("replicated"); likewise x reaches the router as it is,
and the experts through `tp_enter`.  DeepSeek-V2's shared experts are a
dense SwiGLU: column/row parallel when their leaves are slices, their
partial sum joining the experts' before the one exit.

Under sequence parallelism (training) the router, the per-row capacity
dispatch and the aux loss need every token of a row: x is all-gathered
whole first (`stream_gather`: the gradient reaching it is the same on
every rank, the router's whole and the experts' summed by `tp_enter`),
and the exit reduce-scatters into this rank's slice of the stream; a
whole part added after the exit is cut to that slice.

Spans (`repro_torch.tracing`): `model.moe.route`, `model.moe.dispatch`,
`model.moe.experts` (counters `rows`, the slots run, `d_model`,
`d_expert`), `model.moe.combine`, `model.moe.shared`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    maybe_shard, model_axis, stream_gather, stream_scatter, tp_enter)
from repro_torch.models.common import normal_init
from repro_torch.models.config import MoEConfig
from repro_torch.tracing import span


def init_moe(gen, d_model: int, m: MoEConfig, dtype, device):
    e, f = m.num_experts, m.d_expert
    p = {
        "router": normal_init(gen, (d_model, m.num_routed), dtype, device),
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
    """Slots an expert, per row: factor·t·top_k over the router's width."""
    c = int(capacity_factor * num_tokens * m.top_k / m.num_routed)
    return max(min(c, num_tokens), 1)


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, ties to
    the lower index (`lax.top_k`'s order): a stable descending sort."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return probs.gather(-1, idx), idx


def group_limited_top_k(probs, k: int, n_group: int, topk_group: int):
    """DeepSeek-V2's group-limited greedy choice over the last axis of
    `probs` (>= 0), split into `n_group` equal groups: the `topk_group`
    groups of highest maximum, then the k largest entries inside them;
    ties to the lower index at both stages.  (values, indices) as
    `_top_k`."""
    *lead, e = probs.shape
    per = e // n_group
    groups = _top_k(probs.view(*lead, n_group, per).amax(-1), topk_group)[1]
    held = torch.zeros(probs.shape[:-1] + (n_group,), dtype=torch.bool,
                       device=probs.device).scatter(-1, groups, True)
    idx = _top_k(probs.masked_fill(~held.repeat_interleave(per, dim=-1), -1.0),
                 k)[1]
    return probs.gather(-1, idx), idx


def route(params, x, m: MoEConfig, capacity_factor: float, enter_gates: bool = False):
    """Routing and dispatch of every row of x (b, n, d) over the router's
    E = `m.num_routed` experts (module docstring).

    Returns a dict: `slot_token` (b, E, C) int64, the token each expert slot
    holds (n for an empty slot); `slot_gate` (b, E, C), its gate in x's
    dtype (0 for an empty slot); `pair_slot` (b, n, k) int64, the flat slot
    e·C + c each token's j-th choice landed in (E·C when dropped); `aux`
    (b,) f32, each row's load-balance loss.  `enter_gates`: the gates pass
    `tp_enter` (their gradient summed over the model group)."""
    b, n, _ = x.shape
    dt, dev = x.dtype, x.device
    e, k = m.num_routed, m.top_k
    logits = torch.einsum("bnd,de->bne", x, params["router"].to(dt))
    probs = torch.softmax(logits.float(), dim=-1)
    if m.n_group > 1:
        gates, expert_idx = group_limited_top_k(probs, k, m.n_group, m.topk_group)
    else:
        gates, expert_idx = _top_k(probs, k)                   # (b, n, k)
    if m.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    if m.routed_scaling_factor != 1.0:
        gates = gates * m.routed_scaling_factor
    if enter_gates:
        gates = tp_enter(gates)

    # switch-style load balance loss over all-k assignments: with
    # coefficient α/k it is DeepSeek-V2's expert-level α Σ f_i P_i
    frac_tokens = F.one_hot(expert_idx, e).sum(2).float().mean(1)   # (b, E)
    frac_probs = probs.mean(1)                                      # (b, E)
    aux = e * (frac_tokens * frac_probs).sum(-1) * m.router_aux_coef
    if m.device_aux_coef or m.comm_aux_coef:
        # a group stands for a device: P'_i its experts' summed P_j; f'_i
        # the mean of their f_j = E/k · frac_tokens_j; f''_i = G/topk_group
        # × the share of tokens sending any pair to it
        g = m.n_group
        p_dev = frac_probs.view(b, g, e // g).sum(-1)
        f_dev = frac_tokens.view(b, g, e // g).mean(-1) * (e / k)
        sent = F.one_hot(expert_idx // (e // g), g).amax(2).float().mean(1)
        aux = (aux + m.device_aux_coef * (f_dev * p_dev).sum(-1)
               + m.comm_aux_coef * (sent * (g / m.topk_group) * p_dev).sum(-1))

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


def moe_apply(params, x, m: MoEConfig, *, capacity_factor: float | None = None):
    """x: (b, t, d) -> (out, aux_loss): every row is one dispatch group,
    capacity C = factor·t·top_k/num_routed per row; aux is the mean over
    rows.  The held experts' slots run here, every other pair reads the
    zero row; expert and shared leaves that are this rank's slices run
    tensor-parallel (module docstring)."""
    x = stream_gather(x)
    b, n, d = x.shape
    dt = x.dtype
    tp = model_axis()
    e_loc = params["w_gate"].shape[0]
    experts_tp = tp is not None and e_loc != m.num_experts
    shared_tp = (tp is not None and "shared" in params and params["shared"]["w_up"].shape[1]
                 != m.num_shared_experts * m.shared_d_expert)
    x_tp = tp_enter(x) if experts_tp or shared_tp else x
    with span("model.moe.route"):
        r = route(params, x, m, capacity_factor if capacity_factor is not None
                  else m.capacity_factor, enter_gates=experts_tp)
    cap = r["slot_token"].shape[-1]
    with span("model.moe.dispatch"):
        # the held experts' slots; pairs outside them read the zero row
        e0 = m.first_expert + (tp[1] * e_loc if experts_tp else 0)
        n_loc = e_loc * cap
        pair_slot = r["pair_slot"] - e0 * cap
        pair_slot = torch.where((pair_slot >= 0) & (pair_slot < n_loc), pair_slot, n_loc)
        zero_row = torch.zeros((b, 1, d), dtype=dt, device=x.device)
        xe = x_tp if experts_tp else x
        edx = _gather_rows(torch.cat([xe, zero_row], 1),
                           r["slot_token"][:, e0:e0 + e_loc])           # (b,E,C,d)
    with span("model.moe.experts", rows=b * n_loc, d_model=d, d_expert=m.d_expert):
        h = F.silu(torch.einsum("becd,edf->becf", edx, params["w_gate"].to(dt)))
        h = h * torch.einsum("becd,edf->becf", edx, params["w_up"].to(dt))
        eout = torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))
    with span("model.moe.combine"):
        contrib = (eout * r["slot_gate"][:, e0:e0 + e_loc, :, None]).reshape(b, -1, d)
        parts = _gather_rows(torch.cat([contrib, zero_row], 1), pair_slot)
        y = parts[:, :, 0]
        for j in range(1, m.top_k):   # each token's slots, in k order
            y = y + parts[:, :, j]

    whole = None                      # a whole part, added after the exit
    if "shared" in params:
        with span("model.moe.shared"):
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
