"""The share of the traced window in which no operation ran on the card
(the complement of the union of every device operation's interval in the
profiler's trace), on the worst rank."""


def read(run):
    traces = [t for t in run["traces"] if t and t["busy_s"] > 0]
    if not traces:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in traces)
