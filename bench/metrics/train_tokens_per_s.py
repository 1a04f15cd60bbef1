"""Tokens of every step of the window, over the time from the window's
start to the end of its last step (host clock; each step ends with the
host reading its metrics, which waits for the device).  Across all ranks:
a step's tokens are the global batch's."""


def read(run):
    steps = run["steps"]
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / (steps[-1]["t1"] - run["t_start"])
