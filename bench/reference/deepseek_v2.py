"""Plain reference of DeepSeek-V2 (arXiv:2405.04434) at one expert-parallel
rank's share of its experts: token embedding; per layer RMSNorm →
Multi-head Latent Attention → residual, RMSNorm → feed-forward → residual;
a final RMSNorm, an untied output head, mean next-token cross-entropy plus
the balance losses.

Written from the paper's equations (§2.1-§2.2) in plain float32 PyTorch:

* MLA in its expanded form, decoupled RoPE: c^Q = RMSNorm(W^DQ h),
  q = W^UQ c^Q split into [q^C; q^R], q^R rotated; c^KV = RMSNorm(W^DKV h),
  k^C = W^UK c^KV, v = W^UV c^KV; one RoPE key k^R = RoPE(W^KR h) shared
  by every head; softmax([q^C; q^R]·[k^C; k^R] / √(d_h + d_h^R)) over the
  causal past, then W^O.  RoPE rotates the two halves of its dimensions
  (the layout both sides share; the weights are random).
* Layers [0, first_dense) dense SwiGLU; the rest DeepSeekMoE: the shared
  experts (one SwiGLU of their summed width) plus the held routed experts.
  Routing: s = softmax over every router column (the published count);
  group-limited greedy: the `topk_group` groups of highest max s, then the
  top_k experts inside them (ties to the lower index); gate = s ×
  `routed_scaling_factor` (normalised first where `norm_topk_prob`).
  Capacity per expert and sequence C = ⌊factor · t · top_k / E⌋: an
  expert keeps the first C tokens that chose it, in token order.  Only
  the held experts [first_expert, first_expert + num_experts) are
  computed, each over its kept tokens; what the other ranks' experts would
  add is left out.
* Balance losses per sequence (§2.2.3), α1 = k · `router_aux_coef` (the
  file states the port's coefficient), α2 = `device_aux_coef`, α3 =
  `comm_aux_coef`, a routing group standing for a device.

Attention runs in query blocks under `torch.utils.checkpoint`, and each
layer is recomputed in the backward pass as well, so that the reference
fits beside its optimizer state at the timed sizes.  It takes the
parameter tree in the layout the benchmark hands both sides and imports
nothing of the program.  `routing` reports, without gradients, each MoE
layer's choices and the pairs its held experts dropped.

Also here: the benchmark's own parameter and FLOP counts for this family.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512


def _dense_layers(m: dict) -> int:
    return m["moe"]["first_dense"]


def param_shapes(m: dict) -> dict:
    """The parameter tree (shapes) in the layout both sides are handed."""
    d, h, ff, v = m["d_model"], m["num_heads"], m["d_ff"], m["vocab_size"]
    a, e = m["mla"], m["moe"]
    nope, rope = a["qk_nope_head_dim"], a["qk_rope_head_dim"]
    attn = {"w_dq": (d, a["q_lora_rank"]), "q_norm": {"scale": (a["q_lora_rank"],)},
            "w_uq": (a["q_lora_rank"], h, nope + rope),
            "w_dkv": (d, a["kv_lora_rank"]), "kv_norm": {"scale": (a["kv_lora_rank"],)},
            "w_krope": (d, rope), "w_uk": (a["kv_lora_rank"], h, nope),
            "w_uv": (a["kv_lora_rank"], h, a["v_head_dim"]),
            "w_o": (h, a["v_head_dim"], d)}
    norms = {"pre_norm": {"scale": (d,)}, "mlp_norm": {"scale": (d,)}}
    dense = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    held, f = e["num_experts"], e["d_expert"]
    width = e["num_shared_experts"] * e["shared_d_expert"]
    moe = {"router": (d, e["router_experts"]), "w_gate": (held, d, f),
           "w_up": (held, d, f), "w_down": (held, f, d),
           "shared": {"w_gate": (d, width), "w_up": (d, width), "w_down": (width, d)}}
    layers = [dict(norms, attn=attn, mlp=dense if i < _dense_layers(m) else moe)
              for i in range(m["num_layers"])]
    return {"embed": {"table": (v, d)}, "unembed": {"table": (v, d)},
            "final_norm": {"scale": (d,)}, "layers": layers}


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(x) for x in tree.values())
    if isinstance(tree, list):
        return sum(_count(x) for x in tree)
    return math.prod(tree)


def param_count(m: dict) -> int:
    return _count(param_shapes(m))


def flops_per_token(m: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token (forward and backward, no
    recomputation): 6 × the parameters a token uses outside the embedding
    lookup — the output head, every router column, the shared experts and
    the held routed experts at their expected top_k · held / E pairs a
    token, not the capacity's slots — plus 6 × layers × heads × (q·k dim
    + v dim) × sequence for the score and value products over the whole
    t × t (as the dense family counts them)."""
    d, e, a = m["d_model"], m["moe"], m["mla"]
    per_expert = 3 * d * e["d_expert"]
    moe_layers = m["num_layers"] - _dense_layers(m)
    used = param_count(m) - m["vocab_size"] * d
    used -= moe_layers * e["num_experts"] * per_expert
    used += moe_layers * e["top_k"] * e["num_experts"] / e["router_experts"] * per_expert
    att = m["num_heads"] * (a["qk_nope_head_dim"] + a["qk_rope_head_dim"] + a["v_head_dim"])
    return 6.0 * used + 6.0 * m["num_layers"] * att * seq_len


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x (b, t, heads, dim) rotated by position: the first half of its
    dimensions against the second."""
    t, dim = x.shape[1], x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=x.device) / dim))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def _attend_block(q, k, v, start):
    """Causal softmax attention of the queries at positions [start, start +
    rows) over every key."""
    rows, t = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthk,bshk->bhts", q, k) * scale
    qpos = torch.arange(start, start + rows, device=q.device)[:, None]
    mask = torch.arange(t, device=q.device)[None, :] <= qpos
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhts,bshv->bthv", scores.softmax(dim=-1), v)


def _mla(x, a: dict, m: dict, eps: float):
    cfg = m["mla"]
    nope, theta = cfg["qk_nope_head_dim"], m["rope_theta"]
    cq = _rmsnorm(x @ a["w_dq"], a["q_norm"]["scale"], eps)
    q = torch.einsum("btr,rhk->bthk", cq, a["w_uq"])
    q = torch.cat((q[..., :nope], _rope(q[..., nope:], theta)), dim=-1)
    ckv = _rmsnorm(x @ a["w_dkv"], a["kv_norm"]["scale"], eps)
    k_rope = _rope((x @ a["w_krope"])[:, :, None, :], theta)
    k_nope = torch.einsum("btr,rhn->bthn", ckv, a["w_uk"])
    k = torch.cat((k_nope, k_rope.expand(-1, -1, k_nope.shape[2], -1)), dim=-1)
    v = torch.einsum("btr,rhv->bthv", ckv, a["w_uv"])
    t = x.shape[1]
    out = torch.cat([checkpoint(_attend_block, q[:, s:s + Q_BLOCK], k, v, s,
                                use_reentrant=False)
                     for s in range(0, t, Q_BLOCK)], dim=1)
    return torch.einsum("bthv,hvd->btd", out, a["w_o"])


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _choose(s, k: int, groups: int, topk_group: int):
    """Group-limited greedy choice for each row of s (n, E): its experts'
    indices (n, k), best first, ties to the lower index."""
    n, e = s.shape
    per = e // groups
    # a stable sort of (−score) puts equal scores in index order
    best_groups = torch.sort(s.view(n, groups, per).amax(-1), dim=-1, descending=True,
                             stable=True)[1][:, :topk_group]
    allowed = torch.zeros(n, groups, dtype=torch.bool, device=s.device)
    allowed[torch.arange(n, device=s.device)[:, None], best_groups] = True
    allowed = allowed[:, :, None].expand(n, groups, per).reshape(n, e)
    return torch.sort(torch.where(allowed, s, -1.0), dim=-1, descending=True,
                      stable=True)[1][:, :k]


def _moe(x, p: dict, m: dict, record=None):
    """The held experts' part of a DeepSeekMoE layer plus its shared
    experts, and the layer's balance loss (mean over rows).  `record`, a
    list, gets (choices, dropped held pairs) of each row."""
    e = m["moe"]
    b, t, d = x.shape
    n_exp, k = e["router_experts"], e["top_k"]
    groups, topk_group = e["n_group"], e["topk_group"]
    first, held = e["first_expert"], e["num_experts"]
    cap = max(min(int(e["capacity_factor"] * t * k / n_exp), t), 1)
    out, aux = [], []
    for row in range(b):
        xr = x[row]
        s = (xr @ p["router"]).softmax(dim=-1)                     # (t, E)
        chosen = _choose(s.detach(), k, groups, topk_group)         # (t, k)
        picked = torch.zeros(t, n_exp, dtype=torch.bool, device=x.device)
        picked[torch.arange(t, device=x.device)[:, None], chosen] = True
        gate = s * e["routed_scaling_factor"]
        if e["norm_topk_prob"]:
            gate = s / (s * picked).sum(-1, keepdim=True) * e["routed_scaling_factor"]
        y = _swiglu(xr, p["shared"]["w_gate"], p["shared"]["w_up"], p["shared"]["w_down"])
        dropped = 0
        for j in range(held):
            # the first C tokens, in token order, that chose expert first + j
            wants = picked[:, first + j]
            kept = wants & (torch.cumsum(wants.long(), 0) <= cap)
            if record is not None:
                dropped += int(wants.sum() - kept.sum())
            tok = kept.nonzero()[:, 0]
            h = _swiglu(xr[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j])
            y = y.index_add(0, tok, h * gate[tok, first + j, None])
        out.append(y)
        if record is not None:
            record.append((chosen, dropped))
        # balance losses (§2.2.3): f_i = E/(k t) · the tokens choosing
        # expert i, P_i = mean score; a group stands for a device
        f = picked.float().sum(0) * n_exp / (k * t)
        prob = s.mean(0)
        loss = k * e["router_aux_coef"] * (f * prob).sum()
        f_dev = f.view(groups, -1).mean(-1)
        p_dev = prob.view(groups, -1).sum(-1)
        sent = picked.view(t, groups, -1).any(-1).float().sum(0) * groups / (topk_group * t)
        loss = (loss + e["device_aux_coef"] * (f_dev * p_dev).sum()
                + e["comm_aux_coef"] * (sent * p_dev).sum())
        aux.append(loss)
    return torch.stack(out), torch.stack(aux).mean()


def _layer(x, p: dict, m: dict, eps: float, dense: bool, record=None):
    x = x + _mla(_rmsnorm(x, p["pre_norm"]["scale"], eps), p["attn"], m, eps)
    h = _rmsnorm(x, p["mlp_norm"]["scale"], eps)
    f = p["mlp"]
    if dense:
        return x + _swiglu(h, f["w_gate"], f["w_up"], f["w_down"]), x.new_zeros(())
    y, aux = _moe(h, f, m, record)
    return x + y, aux


def _hidden(params, tokens, m, eps, record=None):
    """The final hidden states and the summed balance loss; each layer
    recomputed in the backward pass unless its routing is `record`ed."""
    x = F.embedding(tokens.long(), params["embed"]["table"])
    aux = x.new_zeros(())
    for i, p in enumerate(params["layers"]):
        dense = i < _dense_layers(m)
        if record is None:
            x, a = checkpoint(_layer, x, p, m, eps, dense, use_reentrant=False)
        else:
            x, a = _layer(x, p, m, eps, dense, record)
        aux = aux + a
    return _rmsnorm(x, params["final_norm"]["scale"], eps), aux


def loss(params: dict, tokens, labels, m: dict, eps: float):
    """Mean next-token cross-entropy of (rows, t) `tokens` against `labels`
    plus the balance losses."""
    x, aux = _hidden(params, tokens, m, eps)
    logits = x @ params["unembed"]["table"].t()
    xent = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
    return xent + aux


@torch.no_grad()
def routing(params: dict, tokens, m: dict, eps: float) -> list:
    """For each MoE layer in order and each row of `tokens`: (its experts'
    indices (t, k), the pairs its held experts dropped over capacity)."""
    record = []
    _hidden(params, tokens, m, eps, record)
    return record
