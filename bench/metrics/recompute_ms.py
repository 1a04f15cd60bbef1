"""Device time launched inside a `model.*` span (a layer, an attention or
cross-entropy chunk) that lies inside `step.backward`: the forward work
autograd runs again for the checkpoints, a traced step, on the worst rank
(ms)."""

from benchkit.spans import worst_ms


def read(run):
    return worst_ms(run, lambda t: t["recompute_s"])
