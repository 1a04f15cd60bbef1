"""`fused_adamw_stats` (the flat AdamW tail) against its bytes bound: each
traced step the kernel reads p, g, m, v and writes p, m, v, 7 × 4 bytes a
float32 element of the rank's own flat buffers, at the card's 3.35 TB/s,
over the summed device time of its launches in the trace (all ranks)."""

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
        need += trace["steps"] * 28.0 * elements / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * need / took if took > 0 else None
