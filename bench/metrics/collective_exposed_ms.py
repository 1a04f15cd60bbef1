"""NCCL's device time that no compute kernel overlaps, a traced step, on
the worst rank (ms)."""


def read(run):
    traces = [t for t in run["traces"] if t and t["collective_s"] > 0]
    if not traces:
        return None
    return max(1e3 * t["collective_exposed_s"] / t["steps"] for t in traces)
