"""The benchmark's host spans around the loop's own work a step — making
the batch, `engine.get_step`, `controller_update` — summed over the
window's steps, over their number (ms a step)."""


def read(run):
    steps = run["steps"]
    if not steps:
        return None
    return 1e3 * sum(s["host_s"] for s in steps) / len(steps)
