"""DeepSeek-V2 at one expert-parallel rank's share, on the CPU at the
benchmark configuration's smoke size (`bench/configs/deepseek-v2-236b-
l5e20.json`): a router over every published expert, group-limited greedy
routing, gates scaled and not normalised, and only the held experts run.

* The port's model against the benchmark's plain reference
  (`bench/reference/deepseek_v2.py`) on seeded weights: the loss, every
  gradient leaf, and one ACCUM-NORM flat/flat step.
* Group-limited greedy, the port's and the reference's, against a
  brute-force enumeration of the groups, on scores full of ties.
* The capacity is sized over the router's width, not the experts held.
* The share: every rank's held part summed, with what every rank computes
  alike (layer 0, the attention, the shared experts) counted once, is the
  uncut reference layer with every expert held.
* At their defaults the new `MoEConfig` fields leave the deepseek-v2 and
  dbrx smoke models bit-identical to the layer as it was before them (its
  one-process path, frozen below).

Tolerances: float32 sums in another order, so rtol 1e-5 with an atol of
1e-5 × the largest magnitude, as `test_torch_moe.py` holds the layer to
the JAX reference.
"""

import dataclasses
import itertools
import os
import statistics
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchkit.manifest import load_json, reference_module  # noqa: E402
from benchkit.program import family_shapes, model_dict, port_config  # noqa: E402
from benchkit.refstep import run_reference  # noqa: E402
from benchkit.traffic import MarkovTokens, make_batch  # noqa: E402
from benchkit.weights import leaf_items, make_weights  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.train_step import (  # noqa: E402
    batch_to_device, make_accum_norm_step)
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

REF = reference_module("deepseek_v2")
CONFIG = load_json(os.path.join(BENCH, "configs", "deepseek-v2-236b-l5e20.json"))
M = model_dict(CONFIG, smoke=True)
EPS = 1e-6
CPU = torch.device("cpu")
SEED = 2**31 + 31


def close(got, want, rtol=1e-5):
    want = want.detach().double()
    np.testing.assert_allclose(got.detach().double().numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * max(float(want.abs().max()), 1e-30))


def _with_moe(m: dict, **kw) -> dict:
    return dict(m, moe=dict(m["moe"], **kw))


def _weights(m: dict, seed: int = SEED):
    return make_weights(family_shapes(CONFIG, m, REF), seed, CPU, CONFIG["init"])


def _tokens(m: dict, rows: int = 2, t: int = 64, step: int = 0):
    seqs = MarkovTokens(m["vocab_size"], SEED).sequences(step, rows, t)
    return torch.as_tensor(seqs[:, :-1]), torch.as_tensor(seqs[:, 1:].copy())


def _grads(loss_of, weights):
    leaves, treedef = tree_flatten(weights)
    xs = [x.clone().requires_grad_(True) for x in leaves]
    loss = loss_of(tree_unflatten(treedef, xs))
    return loss, torch.autograd.grad(loss, xs)


# ------------------------------------------------- port vs reference ----

def test_port_loss_and_every_gradient_leaf_match_the_reference():
    model = build_model(port_config(M))
    w = _weights(M)
    tok, lab = _tokens(M)
    # the check exercises what the cell does: drops at capacity, held
    # experts outside the first group, pairs to experts held elsewhere
    record = REF.routing(w, tok, M, EPS)
    assert sum(d for _, d in record) > 0
    first, held = M["moe"]["first_expert"], M["moe"]["num_experts"]
    chosen = torch.cat([c.reshape(-1) for c, _ in record])
    assert ((chosen >= first) & (chosen < first + held)).any() and (chosen < first).any()

    p_loss, p_grads = _grads(lambda t: model.loss(t, {"tokens": tok, "labels": lab})[0], w)
    r_loss, r_grads = _grads(lambda t: REF.loss(t, tok, lab, M, EPS), w)
    close(p_loss, r_loss)
    paths = [p for p, _ in leaf_items(w)]
    assert len(paths) == len(p_grads)
    for path, a, b in zip(paths, p_grads, r_grads):
        assert float(b.abs().max()) > 0, path
        close(a, b)


def test_one_accum_norm_step_matches_the_reference():
    traffic = dict(load_json(os.path.join(BENCH, "traffic", "accum.s4096.json")),
                   seq_len=32, accum=2, global_batch=2)
    opt = traffic["optimizer"]
    batch = make_batch(MarkovTokens(M["vocab_size"], SEED), 0, traffic["accum"], 1,
                       traffic["seq_len"])
    lr = 3e-4
    model = build_model(port_config(M))
    w = _weights(M)
    before = {p: x.clone() for p, x in leaf_items(w)}
    wrap = make_accum_norm_step(
        model, AdamWConfig(lr=lr, beta1=opt["beta1"], beta2=opt["beta2"], eps=opt["eps"],
                           weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]),
        stats_impl="flat", params_impl="flat", params_like=w, device=CPU)
    layout = wrap.flat_layout
    state = init_adamw_flat(w, layout=layout, device=CPU)
    dev = batch_to_device(batch, CPU)
    params, _, metrics = wrap(dev)(tuple(layout.flatten(w)), state, dev, lr)
    update = {p: float(torch.linalg.vector_norm((x - before[p]).double()))
              for p, x in leaf_items(layout.unflatten(list(params)))}

    ref = run_reference(REF, M, EPS, CONFIG["init"], family_shapes(CONFIG, M, REF), SEED,
                        [batch], [lr], traffic, CPU)
    for name in ("loss", "var_l1", "grad_sqnorm"):
        assert float(metrics[name]) == pytest.approx(ref[name][0], rel=1e-5), name
    floor = statistics.median(ref["update_leaf"].values())
    for p, u in update.items():
        assert abs(u - ref["update_leaf"][p]) <= 1e-5 * max(ref["update_leaf"][p], floor), p


# --------------------------------------------------------- routing ----

def _brute_force(scores, k: int, groups: int, topk_group: int) -> list:
    """One token's experts: of every set of `topk_group` groups, the one
    whose group maxima, sorted, are greatest (a lower group index first on
    a tie); then its k best experts (a lower index first on a tie)."""
    per = len(scores) // groups
    gmax = [max(scores[g * per:(g + 1) * per]) for g in range(groups)]
    best = max(itertools.combinations(range(groups), topk_group),
               key=lambda s: sorted(((gmax[g], -g) for g in s), reverse=True))
    experts = [i for g in best for i in range(g * per, (g + 1) * per)]
    return sorted(experts, key=lambda i: (-scores[i], i))[:k]


@pytest.mark.parametrize("e,groups,topk_group,k", [(16, 4, 2, 3), (160, 8, 3, 6),
                                                   (12, 6, 1, 2)])
def test_group_limited_greedy_equals_brute_force_with_ties(e, groups, topk_group, k):
    g = np.random.default_rng(e + k)
    # four levels only: most groups tie on their maximum, most experts on
    # their score
    scores = torch.as_tensor(g.integers(0, 4, (64, e)) / 4.0, dtype=torch.float32)
    want = torch.tensor([_brute_force(s.tolist(), k, groups, topk_group) for s in scores])
    vals, got = tmoe.group_limited_top_k(scores[None], k, groups, topk_group)
    assert torch.equal(got[0], want)
    assert torch.equal(vals[0], scores.gather(1, want))
    assert torch.equal(REF._choose(scores, k, groups, topk_group), want)


def test_capacity_is_sized_over_the_router_width():
    held = MoEConfig(num_experts=20, top_k=6, d_expert=8, router_experts=160,
                     n_group=8, topk_group=3)
    whole = dataclasses.replace(held, num_experts=160, router_experts=0)
    assert tmoe._capacity(4096, held, 1.25) == tmoe._capacity(4096, whole, 1.25) == 192
    m = port_config(M).moe
    x = torch.randn(2, 64, M["d_model"], generator=torch.Generator().manual_seed(1))
    params = tmoe.init_moe(torch.Generator().manual_seed(2), M["d_model"], m,
                           torch.float32, CPU)
    assert params["router"].shape[1] == m.num_routed == 16
    assert params["w_gate"].shape[0] == m.num_experts == 4
    r = tmoe.route(params, x, m, m.capacity_factor)
    assert r["slot_token"].shape == (2, 16, int(1.25 * 64 * 3 / 16))


# ----------------------------------------------------------- share ----

def test_ranks_shares_add_up_to_the_uncut_layer():
    """Two layers: the dense layer 0 and one MoE layer over the router's 16
    experts, 4 a rank on 4 ranks (one group each)."""
    e = M["moe"]["router_experts"]
    held = M["moe"]["num_experts"]
    whole = _with_moe(dict(M, num_layers=2), num_experts=e, first_expert=0)
    w = _weights(whole)
    tok, _ = _tokens(whole)
    x0 = F.embedding(tok, w["embed"]["table"])
    positions = torch.arange(tok.shape[1]).expand(tok.shape)
    layer0, layer1 = w["layers"]

    def block(params, m, x, moe_layer):
        return blocks.block_full(params, x, positions, port_config(m), "mla", moe_layer)[0]

    with torch.no_grad():
        x1 = block(layer0, whole, x0, False)                  # counted once
        # what every rank computes alike: attention, the shared experts
        silent = dict(layer1, mlp=dict(layer1["mlp"],
                                       w_down=torch.zeros_like(layer1["mlp"]["w_down"])))
        alike = block(silent, whole, x1, True)
        total = alike.clone()
        for r in range(e // held):
            cut = slice(r * held, (r + 1) * held)
            mlp = dict(layer1["mlp"], **{n: layer1["mlp"][n][cut]
                                         for n in ("w_gate", "w_up", "w_down")})
            part = block(dict(layer1, mlp=mlp),
                         _with_moe(whole, num_experts=held, first_expert=r * held), x1, True)
            total += part - alike
        want = REF._layer(REF._layer(x0, layer0, whole, EPS, True)[0], layer1, whole, EPS,
                          False)[0]
    close(total, want)


def test_held_share_aux_loss_is_whole():
    m = port_config(M).moe
    whole = dataclasses.replace(m, num_experts=m.num_routed, first_expert=0)
    gen = torch.Generator().manual_seed(3)
    params = tmoe.init_moe(gen, M["d_model"], whole, torch.float32, CPU)
    x = torch.randn(2, 64, M["d_model"], generator=gen)
    cut = slice(m.first_expert, m.first_expert + m.num_experts)
    share = dict(params, **{n: params[n][cut] for n in ("w_gate", "w_up", "w_down")})
    assert torch.equal(tmoe.moe_apply(share, x, m)[1], tmoe.moe_apply(params, x, whole)[1])


# ------------------------------------------------ defaults unchanged ----

def _route_before(params, x, m, capacity_factor):
    """`moe.route` before the router's width, group-limited routing and the
    gate scale (one process: no `tp_enter`)."""
    b, n, _ = x.shape
    dt, dev = x.dtype, x.device
    e, k = m.num_experts, m.top_k
    logits = torch.einsum("bnd,de->bne", x, params["router"].to(dt))
    probs = torch.softmax(logits.float(), dim=-1)
    gates, expert_idx = tmoe._top_k(probs, k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    frac_tokens = F.one_hot(expert_idx, e).sum(2).float().mean(1)
    frac_probs = probs.mean(1)
    aux = e * (frac_tokens * frac_probs).sum(-1) * m.router_aux_coef
    cap = max(min(int(capacity_factor * n * k / e), n), 1)
    nk, n_slots = n * k, e * cap
    pair_expert = expert_idx.reshape(b, nk)
    order = torch.argsort(pair_expert, dim=-1, stable=True)
    se = pair_expert.gather(1, order)
    sg = gates.reshape(b, nk).to(dt).gather(1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(se, experts)
    pos = torch.arange(nk, device=dev) - starts.gather(1, se)
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, n_slots + torch.arange(nk, device=dev))
    slot_token = torch.full((b, n_slots + nk), n, dtype=torch.long, device=dev)
    slot_token = slot_token.scatter(1, dest, order // k)[:, :n_slots]
    slot_gate = torch.zeros((b, n_slots + nk), dtype=dt, device=dev)
    slot_gate = slot_gate.scatter(1, dest, torch.where(keep, sg, 0))[:, :n_slots]
    pair_slot = torch.empty_like(dest).scatter(1, order, dest.clamp(max=n_slots))
    return {"slot_token": slot_token.view(b, e, cap), "slot_gate": slot_gate.view(b, e, cap),
            "pair_slot": pair_slot.view(b, n, k), "aux": aux}


def _moe_before(params, x, m, *, capacity_factor=None):
    """`moe.moe_apply` before held experts (one process, every expert
    held)."""
    b, n, d = x.shape
    r = _route_before(params, x, m, capacity_factor if capacity_factor is not None
                      else m.capacity_factor)
    zero_row = torch.zeros((b, 1, d), dtype=x.dtype)
    edx = tmoe._gather_rows(torch.cat([x, zero_row], 1), r["slot_token"])
    h = F.silu(torch.einsum("becd,edf->becf", edx, params["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", edx, params["w_up"])
    eout = torch.einsum("becf,efd->becd", h, params["w_down"])
    contrib = (eout * r["slot_gate"][..., None]).reshape(b, -1, d)
    parts = tmoe._gather_rows(torch.cat([contrib, zero_row], 1), r["pair_slot"])
    y = parts[:, :, 0]
    for j in range(1, m.top_k):
        y = y + parts[:, :, j]
    if "shared" in params:
        y = y + tmoe._swiglu(params["shared"], x)
    return y, r["aux"].mean()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_defaults_leave_the_smoke_models_bit_identical(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    w = model.init(0, "cpu")
    g = torch.Generator().manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    now = _grads(lambda t: model.loss(t, batch)[0], w)
    monkeypatch.setattr(blocks, "moe_apply", _moe_before)
    before = _grads(lambda t: model.loss(t, batch)[0], w)
    assert torch.equal(now[0], before[0])
    assert all(torch.equal(a, b) for a, b in zip(now[1], before[1]))
