"""Device time launched inside the program's `model.moe.route`,
`model.moe.dispatch` and `model.moe.combine` spans: the router, its
softmax and choice, the capacity sort, the slot gather and the gated sum
back into token rows, forward and recompute, a traced step, on the worst
rank (ms).  The backward's own kernels stay in `backward_ms`.  None where
the program records none of them."""

from benchkit.spans import worst_ms

SPANS = ("model.moe.route", "model.moe.dispatch", "model.moe.combine")


def read(run):
    if not any(t and set(SPANS) & set(t.get("by_span", {})) for t in run["traces"]):
        return None
    return worst_ms(run, lambda t: sum(t["by_span"].get(s, 0.0) for s in SPANS))
