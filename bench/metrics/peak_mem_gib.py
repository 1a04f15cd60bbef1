"""`torch.cuda.max_memory_allocated` over the window (reset after set-up),
on the fullest rank, in GiB."""


def read(run):
    peaks = [p for p in run["peak_mem_bytes"] if p is not None]
    return max(peaks) / 2**30 if peaks else None
