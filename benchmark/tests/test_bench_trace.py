"""The device trace's reduction, on a made-up trace (the CPU has no
device rows): busy as the union of kernels and copies, copies apart,
annotation rows left out, idle time by the span open at each instant."""

import pytest
from torch.autograd import DeviceType

from benchmark import spans


class Event:
    def __init__(self, name, a, b, device):
        self._n, self._a, self._b, self._d = name, a, b, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return DeviceType.CPU if self._d == "cpu" else DeviceType.CUDA

    def is_user_annotation(self):
        return self._n.startswith(("span:", "benchmark."))


class Prof:
    def __init__(self, events):
        self.profiler = type("K", (), {})()
        self.profiler.kineto_results = type("R", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_reduce_trace():
    ev = [Event(spans.WINDOW, 0, 100, "cpu"), Event(spans.REQUEST, 0, 60, "cpu"),
          Event("span:a", 10, 30, "cpu"), Event("span:b", 30, 50, "cpu"),
          Event("span:a", 10, 30, "cuda"),         # the annotation's copy
          Event("k1", 0, 5, "cuda"), Event("k2", 2, 8, "cuda"),
          Event("Memcpy HtoD (Pageable -> Device)", 40, 45, "cuda")]
    r = spans.reduce_trace(Prof(ev))
    ns = 1e-9
    assert r["window_s"] == pytest.approx(100 * ns)
    assert r["busy_s"] == pytest.approx(13 * ns)
    assert r["kernel_s"] == pytest.approx(11 * ns)
    assert r["copy_s"] == pytest.approx(5 * ns)
    idle = dict(r["breakdown"]["idle_gaps"])
    assert idle == pytest.approx({"outside requests": 40 * ns, "a": 20 * ns,
                                  spans.REQUEST: 12 * ns, "b": 15 * ns})
    assert sum(idle.values()) == pytest.approx(87 * ns)
    assert [n for n, _ in r["breakdown"]["device_ops"]][0] == "k2"


def test_no_device_rows_reads_nothing():
    assert spans.reduce_trace(Prof([Event(spans.WINDOW, 0, 9, "cpu")])) is None
