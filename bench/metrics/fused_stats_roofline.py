"""`fused_stats` (FSDP-Norm's statistic, ‖g_j − g‖² and ‖g‖² in one pass)
against its bytes bound: each launch reads the worker's gradient and the
mean gradient over the whole flat buffers (one launch covers every
bucket), 2 × 4 bytes a float32 element, at the card's 3.35 TB/s, over the
summed device time of its launches.  The bytes follow the launches the
trace holds, not the traced steps (all ranks)."""

KERNEL = "stats_kernel"


def read(run):
    if run["peaks"] is None:
        return None
    need, took = 0.0, 0.0
    for trace in run["traces"]:
        if not trace:
            continue
        for name, (count, secs) in trace["kernels"].items():
            if KERNEL in name:
                took += secs
                need += count * 8.0 * run["full_elements"] / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * need / took if took > 0 else None
