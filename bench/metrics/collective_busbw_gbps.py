"""NCCL bus bandwidth of the program's collectives: the bus bytes of the
`comm.*` spans' counters (all-gather and reduce-scatter (n−1)/n × the
whole payload, all-reduce 2(n−1)/n × it) over the NCCL device time
launched inside them, on the slowest rank (GB/s, 1e9 bytes)."""


def read(run):
    rates = []
    for t in run["traces"]:
        secs = sum(c["nccl_s"] for c in t["comm"].values()) if t and "comm" in t else 0.0
        if secs > 0:
            rates.append(sum(c["bus_bytes"] for c in t["comm"].values()) / secs / 1e9)
    return min(rates) if rates else None
