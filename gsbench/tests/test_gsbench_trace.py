"""The traced window's arithmetic: the device's busy time is the union of
its operations' intervals, never their sum; operations split into the five
kernel families and the glue; idle gaps named by the host's range."""

import importlib

import pytest
import torch

from gsbench import cell as cells
from gsbench import trace


def test_union_not_sum():
    # two streams: [0, 10) and [5, 15) overlap, [20, 30) holds [25, 26)
    busy, gaps = trace.union_seconds([(20, 30), (0, 10), (25, 26), (5, 15)])
    assert busy == pytest.approx(25e-9) and gaps == [(15, 20)]
    assert sum(e - s for s, e in [(20, 30), (0, 10), (25, 26), (5, 15)]) == 31


class _Event:
    def __init__(self, name, start, dur, device, tid=1):
        self._n, self._s, self._d, self._dev, self._t = name, start, dur, device, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._t


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_reduce_on_a_synthetic_timeline():
    ev = [
        _Event(trace.WINDOW, 100, 1000, False),
        _Event("gsbench.issue", 100, 300, False),
        _Event("void rasterize_forward_kernel<true>(float*)", 150, 200, True),
        _Event("elementwise_kernel", 250, 200, True),  # overlaps K1 on a second stream
        _Event("cudaStreamSynchronize", 450, 650, False),
        _Event("onesweep_pass(unsigned int const*)", 700, 100, True),
        _Event("segment_sum_packed_kernel", 1050, 100, True),  # runs past the window
        _Event("memcpy HtoD", 50, 20, True),  # before the window
        _Event(trace.WINDOW, 100, 1000, True),  # the window's range mirrored on the device
    ]
    t = trace.reduce(_Prof(ev), "train", 2)
    assert t.window_s == pytest.approx(1000e-9)
    # union: [150, 450) + [700, 800) + [1050, 1100) = 300 + 100 + 50 ns
    assert t.busy_s == pytest.approx(450e-9)
    assert t.family_s["K1"] == pytest.approx(200e-9) and t.family_s["K3"] == pytest.approx(100e-9)
    assert t.family_s["K4"] == pytest.approx(50e-9) and t.glue_s == pytest.approx(200e-9)
    # the gaps: [450, 700) under the sync, [800, 1050), [100, 150) under the issue
    assert t.idle_gaps[0] == ["cudaStreamSynchronize", pytest.approx(250e-9)]
    assert [g[1] for g in t.idle_gaps] == pytest.approx([250e-9, 250e-9, 50e-9])
    assert t.idle_gaps[2][0] == "gsbench.issue"
    idle = cells.reader("device_idle_pct.train").read(type("O", (), {"traced": t})())
    assert idle == pytest.approx(55.0)
    assert cells.reader("device_idle_pct.render").read(type("O", (), {"traced": t})()) is None


def test_families_by_global_name():
    assert trace.family("void segment_sum_kernel(float*, float const*)") == "K4"
    assert trace.family("segment_sum_packed_kernel") == "K4"
    assert trace.family("radix_histogram") == "K3"
    assert trace.family("void at::native::vectorized_elementwise_kernel<4>") is None


def test_readers_return_nothing_without_a_device():
    t = trace.Traced("train", 4, 1.0, 0.0, {f: 0.0 for f in trace.FAMILIES}, 0.0, [], [],
                     bounds_s=0.1, flops=1e9)
    out = type("O", (), {"traced": t})()
    for name in ("device_idle_pct.train", "glue_ms_per_iter.train",
                 "kernels_roofline_pct.train", "mfu_pct.train"):
        assert cells.reader(name).read(out) is None
    assert importlib.import_module("gsbench.roofline").FP32_OPS_PER_S == 67e12
