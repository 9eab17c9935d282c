"""The trace's reduction on synthetic events: the busy union over the
measured window (idle edges count), copies by direction, gap labels."""

import pytest

from portbench import trace
from portbench.trace import Event


def ev(name, start, end, on_device=False, kind="cpu_op"):
    return Event(name, start, end, on_device, kind)


def test_busy_union_over_the_measured_window():
    evs = [
        ev("window", 100, 1100, kind="user_annotation"),
        ev("request", 100, 150, kind="user_annotation"),
        ev("cudaLaunchKernel", 120, 140, kind="cuda_runtime"),
        ev("ready", 150, 600, kind="user_annotation"),
        ev("cudaDeviceSynchronize", 160, 600, kind="cuda_runtime"),
        ev("void pyramid_kernel<1>(Params)", 200, 400, True, "kernel"),
        ev("void pyramid_kernel<1>(Params)", 350, 500, True, "kernel"),  # overlaps
        ev("Memcpy HtoD (Pinned -> Device)", 700, 800, True, "gpu_memcpy"),
        ev("Memcpy DtoH (Device -> Pageable)", 1050, 1200, True, "gpu_memcpy"),  # clipped
        ev("Memset (Device)", 900, 910, True, "gpu_memset"),
        ev("window", 100, 1100, True, "gpu_user_annotation"),  # not device work
        ev("void box_kernel<0>(P)", 0, 50, True, "kernel"),  # before the window
    ]
    s = trace.summarise(evs)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((300 + 100 + 10 + 50) * 1e-9)
    assert s.kernel_s == pytest.approx((200 + 150) * 1e-9)
    assert s.device_ops[0] == ["pyramid_kernel<1>", pytest.approx(350e-9)]
    idle = dict(s.idle_gaps)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    # each gap by the host's activity at its middle: 100-200 (150: the wait
    # has begun, no call yet), 500-700 (600: in the synchronise), 800-900
    # and 910-1050 (no span of the benchmark)
    assert idle == pytest.approx({"ready": 100e-9, "ready: cudaDeviceSynchronize": 200e-9,
                                  "between": 240e-9})


def test_no_window_no_summary():
    assert trace.summarise([ev("x", 0, 1, True, "kernel")]) is None


def test_short_name():
    assert trace.short_name("void bilinear_kernel<2, 2, 0, 1>(unsigned char const*)") == \
        "bilinear_kernel<2, 2, 0, 1>"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
    assert trace.short_name("void (anonymous namespace)::pyramid_kernel<(int)1>(Params, "
                            "unsigned char const*)") == "pyramid_kernel<(int)1>"


class _OldEvent:
    """A kineto event of a torch release without ``activity_type``."""

    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def test_events_without_activity_type():
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [_OldEvent("window", 0, 100, "DeviceType.CPU"),
                            _OldEvent("window", 0, 100, "DeviceType.CUDA"),
                            _OldEvent("void k<1>(int)", 10, 20, "DeviceType.CUDA"),
                            _OldEvent("Memcpy HtoD (Pinned -> Device)", 40, 10,
                                      "DeviceType.CUDA")]

    kinds = [(e.name, e.kind) for e in trace.events(Prof())]
    assert kinds[1:] == [("window", "gpu_user_annotation"), ("void k<1>(int)", "kernel"),
                         ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy")]
    s = trace.summarise(trace.events(Prof()))
    assert s.busy_s == pytest.approx(30e-9) and s.kernel_s == pytest.approx(20e-9)
