"""The plain reference of the timed training step, written from the
paper's equations (Algorithm 1 with AdamW) and run over the cell's first
steps on the same weights, batches and learning rates as the program.

Per step it computes each group's gradient of the mean cross-entropy (the
family module's plain `loss`), the group being a microbatch (ACCUM-NORM)
or a data worker's rows (FSDP-Norm); their mean g; the norm test's
statistic

    ACCUM-NORM:  ‖Var‖₁ = J/M · max(0, (Σ_m ‖g_m‖² − M ‖g‖²) / (M − 1))
    FSDP-Norm:   ‖Var‖₁ = 1/J · Σ_j ‖g_j − g‖²

with ‖g‖², and the controller's decision T = ‖Var‖₁ / (η² ‖g‖²) > b; then
global-norm clipping and decoupled-weight-decay AdamW with bias
correction.  Norms and sums are accumulated in float64.  It imports
nothing of the program; with `tf32` set it is the control: the same
arithmetic with float32 products on the TF32 tensor cores.
"""

from __future__ import annotations

import torch

from benchkit.weights import leaf_items, make_weights, map_tree


def _norm64(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _sq64(xs) -> float:
    return sum(_norm64(x) ** 2 for x in xs)


def run_reference(family, model: dict, eps: float, init: dict, like, seed: int,
                  batches, lrs, traffic: dict, device, *, tf32: bool = False,
                  devices=None) -> dict:
    """The check's numbers of the reference, keyed as the program's.
    `devices`: cards to spread the layers over, in order (a model whose
    reference and its optimizer state one card cannot hold); the weights
    are made on `device`."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(family, model, eps, init, like, seed, batches, lrs, traffic,
                    device, devices or [device])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _groups(batch: dict, traffic: dict):
    """Lists of (tokens, labels) row blocks whose mean gradient is one
    group's: a microbatch each (ACCUM-NORM); a worker's rows of every
    microbatch each (FSDP-Norm)."""
    tok, lab = batch["tokens"], batch["labels"]
    if traffic["step"] == "accum_norm":
        return [[(tok[i], lab[i])] for i in range(tok.shape[0])]
    j, rows = traffic["workers"], tok.shape[1] // traffic["workers"]
    return [[(tok[i, w * rows:(w + 1) * rows], lab[i, w * rows:(w + 1) * rows])
             for i in range(tok.shape[0])] for w in range(j)]


def _place(path: str, layers: int, devices):
    """The card of a leaf: layer i on the (i·n/layers)-th of n cards, the
    embedding on the first, the final norm and the output head on the
    last."""
    parts = path.split("/")
    if parts[0] == "layers":
        return devices[int(parts[1]) * len(devices) // layers]
    return devices[0] if parts[0] == "embed" else devices[-1]


def _run(family, model, eps, init, like, seed, batches, lrs, traffic, device, devices):
    opt = traffic["optimizer"]
    b1, b2 = opt["beta1"], opt["beta2"]
    w = make_weights(like, seed, device, init)
    paths = [p for p, _ in leaf_items(w)]
    layers = model["num_layers"]
    leaves = [x.to(_place(p, layers, devices), copy=True).requires_grad_(True)
              for p, x in leaf_items(w)]
    by_path = dict(zip(paths, leaves))
    tree = map_tree(lambda p, _: by_path[p], w)
    del w
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    out = {"loss": [], "var_l1": [], "grad_sqnorm": [], "T": [], "decision": []}
    at_max = False
    for k, (batch, lr) in enumerate(zip(batches, lrs)):
        batch = {n: torch.as_tensor(a).to(device) for n, a in batch.items()}
        groups = _groups(batch, traffic)
        n_groups = len(groups)
        g = [torch.zeros_like(x) for x in leaves]
        sq, losses = 0.0, []
        for group in groups:
            gj = None
            for tok, lab in group:
                loss = family.loss(tree, tok, lab, model, eps)
                grads = torch.autograd.grad(loss, leaves)
                losses.append(float(loss.detach().double()))
                if len(group) == 1:
                    gj = grads
                else:
                    if gj is None:
                        gj = [torch.zeros_like(x) for x in leaves]
                    for a, gr in zip(gj, grads):
                        a.add_(gr, alpha=1.0 / len(group))
                del grads, loss
            sq += _sq64(gj)
            for a, gr in zip(g, gj):
                a.add_(gr, alpha=1.0 / n_groups)
            del gj
        gsq = _sq64(g)
        if traffic["step"] == "accum_norm":
            var_l1 = (max(0.0, (sq - n_groups * gsq) / (n_groups - 1))
                      * traffic["workers"] / n_groups if n_groups > 1 else 0.0)
        else:
            # (1/J) Σ_j ‖g_j − g‖², g the mean of the g_j
            var_l1 = (sq - n_groups * gsq) / n_groups
        t_stat = var_l1 / (traffic["eta"] ** 2 * gsq + 1e-30)
        out["loss"].append(sum(losses) / len(losses))
        out["var_l1"].append(var_l1)
        out["grad_sqnorm"].append(gsq)
        out["T"].append(t_stat)
        out["decision"].append("untested" if at_max else
                               "grow" if t_stat > traffic["global_batch"] else "stay")
        at_max = at_max or t_stat > traffic["global_batch"]
        # clip, then AdamW with bias correction and decoupled weight decay
        scale = min(opt["grad_clip"] / (gsq ** 0.5 + 1e-12), 1.0) \
            if opt["grad_clip"] > 0 else 1.0
        c1, c2 = 1.0 - b1 ** (k + 1), 1.0 - b2 ** (k + 1)
        with torch.no_grad():
            for x, gr, mi, vi in zip(leaves, g, m, v):
                gr.mul_(scale)
                mi.mul_(b1).add_(gr, alpha=1 - b1)
                vi.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                x.mul_(1.0 - lr * opt["weight_decay"]).sub_(
                    lr * (mi / c1) / ((vi / c2).sqrt() + opt["eps"]))
        if k == 0:
            out["grad_leaf"] = dict(zip(paths, (_norm64(x) for x in g)))
        del g
    p0 = dict(leaf_items(make_weights(like, seed, device, init)))
    with torch.no_grad():
        out["update_leaf"] = {p: _norm64(x - p0[p].to(x.device))
                              for p, x in zip(paths, leaves)}
    del p0
    out["m_leaf"] = dict(zip(paths, (_norm64(x) for x in m)))
    out["v_leaf"] = dict(zip(paths, (_norm64(x) for x in v)))
    return out

