"""Device time launched inside the program's `step.backward` spans less
the recompute there (`recompute_ms`), a traced step, on the worst rank
(ms)."""

from benchkit.spans import worst_ms


def read(run):
    return worst_ms(run, lambda t: t["by_phase"].get("step.backward", 0.0)
                    - t["recompute_s"])
