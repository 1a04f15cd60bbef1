"""Device time launched inside the program's `step.forward` spans (the
microbatches' forward passes, checkpointed chunks included the first time
they run), a traced step, on the worst rank (ms)."""

from benchkit.spans import worst_ms


def read(run):
    return worst_ms(run, lambda t: t["by_phase"].get("step.forward", 0.0))
