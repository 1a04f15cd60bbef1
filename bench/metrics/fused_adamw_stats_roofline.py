"""`fused_adamw_stats` (the flat AdamW tail) against its bytes bound: each
launch reads p, g, m, v and writes p, m, v over the rank's own flat
buffers (one launch covers every bucket: they are all float32), 7 × 4
bytes an element, at the card's 3.35 TB/s, over the summed device time of
its launches.  The bytes follow the launches the trace holds, not the
traced steps: a trace that lost a launch loses its bytes with its time
(all ranks)."""

KERNEL = "adamw_kernel"


def read(run):
    if run["peaks"] is None:
        return None
    need, took = 0.0, 0.0
    for trace, elements in zip(run["traces"], run["flat_elements"]):
        if not trace:
            continue
        for name, (count, secs) in trace["kernels"].items():
            if KERNEL in name:
                took += secs
                need += count * 28.0 * elements / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * need / took if took > 0 else None
