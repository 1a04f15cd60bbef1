"""Device time launched inside the program's `model.mla` spans, its query
chunks' `model.attention` spans included: MLA's forward and its
recompute, a traced step, on the worst rank (ms).  The backward's own
kernels stay in `backward_ms`.  None where the program records no
`model.mla` span."""

from benchkit.spans import worst_ms


def read(run):
    if not any(t and "model.mla" in t.get("by_span", {}) for t in run["traces"]):
        return None
    return worst_ms(run, lambda t: t["by_span"].get("model.mla", 0.0)
                    + t["by_span"].get("model.attention", 0.0))
