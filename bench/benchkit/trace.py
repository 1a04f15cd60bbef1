"""Reduce one rank's `torch.profiler` trace of the traced steps to the
numbers the per-layer readers take: the traced window, the device's busy
seconds in it (the union of every device operation's interval), each
kernel's launches and seconds, the collectives' time that no compute
kernel overlaps, and the breakdown (the device operations that took most
time, and the device's idle time by what the host was doing meanwhile).

The benchmark's own clock marks the traced steps and its host calls;
nothing is read from the program but its kernels' names.
"""

from __future__ import annotations

import numpy as np


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted [start, end) intervals of an (n, 2) array."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def _length(iv: np.ndarray) -> int:
    return int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0


def _minus(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the merged intervals `a` not covered by merged `b`."""
    total, j = 0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return int(total)


def reduce_events(events, window: tuple[int, int], steps: int, host_spans=(),
                  *, top: int = 10, named_gaps: int = 400) -> dict:
    """The trace's numbers over `window` (start, end in ns of the clock
    `time.time_ns` reads, which the profiler's timestamps follow), which
    holds `steps` traced steps.  `host_spans`: (name, start, end) of the
    benchmark's own host calls, which name the idle gaps they cover."""
    from torch.autograd import DeviceType

    w0, w1 = window
    dev, cpu = [], list(host_spans)
    n_host = len(cpu)
    for e in events:
        if e.is_user_annotation():
            continue
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if s + d > w0 and s < w1:
                dev.append((e.name(), max(s, w0), min(s + d, w1)))
        else:
            cpu.append((e.name(), s, s + d))
    iv = np.asarray([(s, e) for _, s, e in dev], dtype=np.int64).reshape(-1, 2)
    busy = _union(iv)
    kernels: dict[str, list] = {}
    for n, s, e in dev:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    is_nccl = np.asarray(["nccl" in n.lower() for n, _, _ in dev], dtype=bool)
    nccl = _union(iv[is_nccl]) if len(iv) else iv
    compute = _union(iv[~is_nccl]) if len(iv) else iv
    exposed = _minus(nccl, compute)

    # idle gaps inside the window, each named by the benchmark's host span
    # running at its middle, else the innermost host operation there
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    every_gap = edges[edges[:, 1] > edges[:, 0]]
    gaps = every_gap[np.argsort(every_gap[:, 0] - every_gap[:, 1],
                                kind="stable")][:named_gaps]
    names = np.asarray([n for n, _, _ in cpu], dtype=object)
    cs = np.asarray([s for _, s, _ in cpu], dtype=np.int64)
    ce = np.asarray([e for _, _, e in cpu], dtype=np.int64)
    own = np.arange(len(cpu)) < n_host
    idle: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        inside = (cs <= mid) & (ce >= mid)
        pick = np.nonzero(inside & own)[0]
        if not len(pick):
            pick = np.nonzero(inside)[0]
        name = (names[pick[np.argmin(ce[pick] - cs[pick])]] if len(pick)
                else "no traced host call (the program's Python)")
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-9
    if len(every_gap) > len(gaps):
        idle[f"{len(every_gap) - len(gaps)} shorter gaps, not named"] = (
            _length(every_gap) * 1e-9 - sum(idle.values()))
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "steps": steps,
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": _length(busy) * 1e-9,
        "kernels": kernels,
        "collective_s": _length(nccl) * 1e-9,
        "collective_exposed_s": exposed * 1e-9,
        "device_ops": [[n, v[1]] for n, v in by_time[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(idle.items(),
                                                key=lambda kv: -kv[1])[:top]],
    }
