"""``devtrace.reduce`` on a hand-made trace: busy time merged over
overlapping device work, idle gaps named by the host event running at
their middle (short ones summed apart), graph-launched kernels counted
apart, copies not counted as kernels."""
from torch.autograd import DeviceType

from bench import devtrace


class Ev:
    def __init__(self, name, start, dur, dev=DeviceType.CPU, corr=0):
        self._v = (name, start, dur, dev, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class Result:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce():
    cuda = DeviceType.CUDA
    us = 1000
    events = [
        Ev(devtrace.WINDOW, 0, 1000 * us),
        Ev("cudaGraphLaunch", 10 * us, 5 * us, corr=7),
        Ev("aten::linalg_eigh", 500 * us, 300 * us),
        Ev("cudaLaunchKernel", 600 * us, 5 * us, corr=8),
        Ev("kernel_a", 100 * us, 200 * us, cuda, corr=7),
        Ev("kernel_b", 250 * us, 100 * us, cuda, corr=7),   # overlaps a
        Ev("kernel_a", 360 * us, 100 * us, cuda, corr=7),   # 10 us gap
        Ev("Memcpy DtoH (Device -> Pageable)", 900 * us, 50 * us, cuda,
           corr=9),
        Ev(devtrace.WINDOW, 0, 1000 * us, cuda),             # its mirror
    ]
    t = devtrace.reduce(Result(events))
    assert t.window_s == 1e-3
    assert abs(t.busy_s - 0.350e-3 - 0.050e-3) < 1e-12
    assert t.kernels == 3 and t.graph_kernels == 3
    assert abs(t.graph_kernel_s - 400e-6) < 1e-12
    gaps = dict(t.idle_gaps)
    assert abs(gaps[devtrace.SHORT_GAPS] - 10e-6) < 1e-12
    assert abs(gaps["aten::linalg_eigh"] - 440e-6) < 1e-12   # 460..900
    assert abs(gaps[devtrace.WINDOW] - 150e-6) < 1e-12       # 0..100, 950..
    assert abs(dict(t.device_ops)["kernel_a"] - 300e-6) < 1e-12


def test_the_profilers_own_stall_is_read_apart():
    """Idle time under the profiler's buffer flush is counted as its stall,
    only where it overlaps an idle gap; the busy time is unchanged."""
    cuda = DeviceType.CUDA
    us = 1000
    events = [
        Ev(devtrace.WINDOW, 0, 1000 * us),
        Ev("kernel_a", 0, 200 * us, cuda),
        Ev("Buffer Flush", 150 * us, 300 * us),        # idle 200..450
        Ev("Activity Buffer Request", 400 * us, 100 * us),   # 450..500
        Ev("kernel_a", 600 * us, 400 * us, cuda),
        Ev("Buffer Flush", 700 * us, 100 * us),        # over busy time
    ]
    t = devtrace.reduce(Result(events))
    assert abs(t.busy_s - 600e-6) < 1e-12
    assert abs(t.profiler_stall_s - 300e-6) < 1e-12


def test_no_device_work_reads_nothing():
    assert devtrace.reduce(Result([Ev(devtrace.WINDOW, 0, 10)])) is None
