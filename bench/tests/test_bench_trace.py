"""The trace's reduction and the per-layer readers, on a made-up trace."""

import pytest
from torch.autograd import DeviceType

import bench_setup  # noqa: F401  (the import path)
from benchkit.manifest import metric_reader
from benchkit.trace import reduce_events


class Ev:
    def __init__(self, name, start, end, dev=True, note=False):
        self._n, self._s, self._d, self._dev, self._note = name, start, end - start, dev, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._note


EVENTS = [Ev("gemm", 0, 400), Ev("gemm", 300, 600), Ev("void adamw_kernel<float>", 700, 800),
          Ev("ncclDevKernel_AllReduce", 550, 750), Ev("ncclDevKernel_AllGather", 900, 950),
          Ev("bench.step", 0, 1000, note=True), Ev("cudaStreamSynchronize", 800, 1000, dev=False)]


def test_busy_idle_and_exposed_collectives():
    t = reduce_events(EVENTS, (0, 1000), 2, [("bench.controller", 950, 1000)])
    assert t["window_s"] == pytest.approx(1000e-9)
    # device busy [0, 800) and [900, 950)
    assert t["busy_s"] == pytest.approx(850e-9)
    # nccl [550, 750) ∪ [900, 950); compute [0, 600) ∪ [700, 800)
    assert t["collective_s"] == pytest.approx(250e-9)
    assert t["collective_exposed_s"] == pytest.approx(150e-9)
    assert t["kernels"]["gemm"] == [2, pytest.approx(700e-9)]
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-9)
    assert gaps["bench.controller"] == pytest.approx(50e-9)
    assert "bench.step" not in dict(t["device_ops"])


def _view(trace, **kw):
    v = {"chips": 1, "trace": True, "setup_s": 20.0, "t_start": 0.0, "t_untraced": None,
         "steps": [{"t0": 0.0, "t1": 2.0, "tokens": 16384, "host_s": 0.01, "traced": False},
                   {"t0": 2.0, "t1": 4.0, "tokens": 16384, "host_s": 0.03, "traced": False}],
         "flops_per_token": 6.0e9, "peaks": {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12},
         "peak_mem_bytes": [2**34], "traces": [trace], "flat_elements": [1000],
         "full_elements": 1000}
    v.update(kw)
    return v


def test_readers():
    t = reduce_events(EVENTS, (0, 1000), 2)
    v = _view(t)
    assert metric_reader("train_tokens_per_s")(v) == pytest.approx(8192.0)
    assert metric_reader("peak_mem_gib")(v) == 16.0
    assert metric_reader("host_loop_ms")(v) == pytest.approx(20.0)
    assert metric_reader("mfu")(v) == pytest.approx(100 * 6e9 * 8192 / 67e12)
    assert metric_reader("device_idle_pct")(v) == pytest.approx(15.0)
    assert metric_reader("collective_exposed_ms")(v) == pytest.approx(150e-9 / 2 * 1e3)
    # one launch in the trace: one launch's bytes
    want = 100 * (1 * 28 * 1000 / 3.35e12) / 100e-9
    assert metric_reader("fused_adamw_stats_roofline")(v) == pytest.approx(want)


@pytest.mark.parametrize("name, kernel", [("fused_adamw_stats_roofline", "adamw_kernel"),
                                          ("fused_stats_roofline", "stats_kernel")])
def test_roofline_counts_launches_not_steps(name, kernel):
    # three traced steps of one launch each, 100 ns a launch; a trace that
    # lost one of the three launches reads the same share
    whole = {"steps": 3, "kernels": {f"void {kernel}<float>": [3, 300e-9]}}
    lost = {"steps": 3, "kernels": {f"void {kernel}<float>": [2, 200e-9]}}
    read = metric_reader(name)
    assert read(_view(lost)) == pytest.approx(read(_view(whole)))
    assert read(_view(whole)) == pytest.approx(
        100 * (28 if kernel == "adamw_kernel" else 8) * 1000 / 3.35e12 / 100e-9)


def test_readers_find_nothing_without_a_trace_or_a_card():
    v = _view(None, traces=[None], peaks=None)
    for name in ("mfu", "device_idle_pct", "fused_adamw_stats_roofline",
                 "fused_stats_roofline", "collective_exposed_ms"):
        assert metric_reader(name)(v) is None
