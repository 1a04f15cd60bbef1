"""The trace's device time put down to the program's spans
(`benchkit/spans.py`) and the readers of it, on made-up events that carry
correlation ids."""

import pytest
from torch.autograd import DeviceType

import bench_setup  # noqa: F401  (the import path)
from benchkit import spans as spans_lib
from benchkit import trace as trace_lib
from benchkit.manifest import metric_reader
from repro_torch.tracing import Span
from test_bench_trace import EVENTS

READERS = ("forward_ms", "backward_ms", "recompute_ms", "grad_accum_ms",
           "forward_ms.fsdp", "backward_ms.fsdp", "recompute_ms.fsdp",
           "grad_accum_ms.fsdp", "collective_busbw_gbps")


class Ev:
    """A device operation (`dev`) or a host call, with its correlation id."""

    def __init__(self, name, start, end, corr, dev=True):
        self._n, self._s, self._d, self._c, self._dev = name, start, end - start, corr, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c


def _span(i, name, start, end, parent=None, thread=1, **counts):
    return Span(i, name, start, end, parent, 0, thread, counts)


# one step on [0, 900]; the recompute's spans on autograd's thread (2)
SPANS = [_span(0, "step", 0, 900),
         _span(1, "step.forward", 10, 200, 0),
         _span(2, "model.attention", 50, 150, 1),
         _span(3, "step.backward", 210, 600, 0),
         _span(4, "model.block", 300, 500, None, thread=2),
         _span(5, "model.attention", 350, 400, 4, thread=2),
         _span(6, "step.accumulate", 610, 700, 0),
         _span(7, "step.exchange", 710, 800, 0),
         _span(8, "comm.all_reduce", 720, 790, 7, bytes=1000, group=4),
         _span(9, "step.gather_params", 805, 860, 0),
         _span(10, "comm.all_gather", 810, 850, 9, bytes=400, group=4)]

# (launch at, device op, its interval): each launch a 5 ns runtime call
LAUNCHES = [(20, "gemm", 100, 200), (60, "softmax", 200, 260), (220, "gemm", 300, 500),
            (320, "gemm", 500, 540), (360, "masked_fill", 540, 560), (650, "add", 700, 730),
            (730, "ncclDevKernel_AllReduce", 740, 840),
            (820, "ncclDevKernel_AllGather", 850, 870), (950, "Memcpy DtoH", 960, 980)]
EV = ([Ev("cudaLaunchKernel", t, t + 5, c) for c, (t, _, _, _) in enumerate(LAUNCHES, 1)]
      + [Ev(n, s, e, c) for c, (_, n, s, e) in enumerate(LAUNCHES, 1)]
      + [Ev("lost launch", 990, 995, 99), Ev("cudaStreamSynchronize", 900, 960, 0, dev=False)])
for e in EV[:len(LAUNCHES)]:
    e._dev = False
BENCH = [("bench.controller", 970, 1000)]


def test_device_time_by_span_phase_and_recompute():
    t = spans_lib.reduce_events(EV, (0, 1000), 1, BENCH, SPANS)
    ns = pytest.approx
    assert t["by_phase"] == {"step.forward": ns(160e-9), "step.backward": ns(260e-9),
                             "step.accumulate": ns(30e-9), "step.exchange": ns(100e-9),
                             "step.gather_params": ns(20e-9)}
    assert t["by_span"] == {"step.forward": ns(100e-9), "model.attention": ns(80e-9),
                            "step.backward": ns(200e-9), "model.block": ns(40e-9),
                            "step.accumulate": ns(30e-9), "comm.all_reduce": ns(100e-9),
                            "comm.all_gather": ns(20e-9)}
    # the block and its attention chunk inside step.backward; the forward's
    # attention chunk is not a recompute
    assert t["recompute_s"] == ns(60e-9)
    # outside the step, and a device op whose launch is not in the trace
    assert t["unattributed_s"] == ns(25e-9)
    assert t["comm"] == {
        "comm.all_reduce": {"calls": 1, "bytes": 1000, "bus_bytes": ns(1500.0),
                            "nccl_s": ns(100e-9)},
        "comm.all_gather": {"calls": 1, "bytes": 400, "bus_bytes": ns(300.0),
                            "nccl_s": ns(20e-9)}}
    # today's numbers stand beside the new ones
    base = trace_lib.reduce_events(EV, (0, 1000), 1, BENCH)
    for k in ("window_s", "busy_s", "kernels", "collective_s", "collective_exposed_s",
              "device_ops"):
        assert t[k] == base[k]


def test_gaps_named_by_bench_then_program_spans_then_runtime():
    gaps = dict(spans_lib.reduce_events(EV, (0, 1000), 1, BENCH, SPANS)["idle_gaps"])
    # busy [100, 260) [300, 560) [700, 730) [740, 840) [850, 870) [960, 980) [990, 995)
    assert gaps == {"model.attention": pytest.approx(100e-9),
                    "step.backward": pytest.approx(40e-9),
                    "step.accumulate": pytest.approx(140e-9),
                    "comm.all_reduce": pytest.approx(10e-9),
                    "comm.all_gather": pytest.approx(10e-9),
                    "cudaStreamSynchronize": pytest.approx(90e-9),
                    "bench.controller": pytest.approx(15e-9)}
    before = dict(trace_lib.reduce_events(EV, (0, 1000), 1, BENCH)["idle_gaps"])
    assert "no traced host call (the program's Python)" in before


def test_without_program_spans_the_result_is_todays():
    for host in ([], [("bench.controller", 950, 1000)]):
        assert (spans_lib.reduce_events(EVENTS, (0, 1000), 2, host)
                == trace_lib.reduce_events(EVENTS, (0, 1000), 2, host))


def _view(trace):
    return {"chips": 1, "trace": True, "traces": [trace], "peaks": None, "steps": []}


def test_readers():
    t = spans_lib.reduce_events(EV, (0, 1000), 1, BENCH, SPANS)
    v = _view(t)
    want = {"forward_ms": 160e-6, "backward_ms": 200e-6, "recompute_ms": 60e-6,
            "grad_accum_ms": 30e-6, "collective_busbw_gbps": 1800 / 120e-9 / 1e9}
    for name in READERS:
        assert metric_reader(name)(v) == pytest.approx(want[name.split(".")[0]])
    # the worst rank: the slower phase, the lower bus bandwidth
    slow = dict(t, by_phase=dict(t["by_phase"], **{"step.forward": 320e-9}),
                comm={k: dict(c, nccl_s=2 * c["nccl_s"]) for k, c in t["comm"].items()})
    v2 = dict(v, traces=[t, slow, None])
    assert metric_reader("forward_ms")(v2) == pytest.approx(320e-6)
    assert metric_reader("collective_busbw_gbps")(v2) == pytest.approx(7.5)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_program_spans(name):
    assert metric_reader(name)(_view(None)) is None
    assert metric_reader(name)(_view(trace_lib.reduce_events(EVENTS, (0, 1000), 2))) is None
