"""Device time launched inside the program's `step.accumulate` spans (each
microbatch's weighted gradient added into the accumulator, and
ACCUM-NORM's ‖ĝ^m‖²), a traced step, on the worst rank (ms)."""

from benchkit.spans import worst_ms


def read(run):
    return worst_ms(run, lambda t: t["by_phase"].get("step.accumulate", 0.0))
