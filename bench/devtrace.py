"""The device trace of a traced run, reduced to what the per-layer metrics
read.

``traced(fn)`` runs ``fn`` under the profiler (Kineto: host operations and
the card's activity through CUPTI) inside a ``bench.run`` annotation,
whose host interval is the traced window.  It drives the profiler's own
enable and disable calls, so that stopping it builds no Python event
objects; ``reduce`` reads the raw events once:

  * device activity (kernels, copies, fills) clipped to the window and
    merged into busy intervals: ``busy_s``.  Between them the card is
    idle.  A gap of at least ``NAMED_GAP_NS`` is named by the innermost
    host event running at its middle; shorter ones, the spaces between
    kernels queued back to back, are summed under one name;
  * kernels counted, and those that a CUDA graph replay launched
    (``cudaGraphLaunch``, matched by correlation id) counted and timed
    apart: the replayed rounds;
  * device time by operation name;
  * the profiler's own stall: the idle time that falls inside the host
    events the profiler records of itself (``PROFILER_OWN``: flushing and
    requesting its activity buffers).  The card idles there because the
    profiler holds the host, not because the program does;
    ``profiler_stall_s`` is that time, which the per-layer metrics take
    out of the window and out of the idle time.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, List, Tuple

import numpy as np

WINDOW = "bench.run"
NAMED_GAP_NS = 50_000
SHORT_GAPS = "gaps under 50 us between queued device work"
_NAME = 96      # characters of a kernel's name kept in the breakdown
#: host events that the profiler records of its own work
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    graph_kernels: int
    graph_kernel_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    profiler_stall_s: float = 0.0


def traced(fn: Callable[[], object]):
    """(fn(), the profiler's raw result) with ``fn`` run under the
    profiler."""
    import torch
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _ExperimentalConfig)
    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts)
    try:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        result = _disable_profiler()
    return out, result


def reduce(result, top: int = 10):
    """A ``TraceSummary`` of ``traced``'s result (see the module's
    docstring); None where the trace holds no window or no device work."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    host, launch_graph, own = [], set(), []
    d_start, d_dur, d_name, d_corr = [], [], [], []
    t0 = t1 = None
    for e in result.events():
        name = e.name()
        if e.device_type() == cuda:
            if name != WINDOW:           # the annotation's device mirror
                d_start.append(e.start_ns())
                d_dur.append(e.duration_ns())
                d_name.append(name)
                d_corr.append(e.correlation_id())
            continue
        start = e.start_ns()
        if name == WINDOW:
            t0, t1 = start, start + e.duration_ns()
            continue
        if name.startswith("cudaGraphLaunch"):
            launch_graph.add(e.correlation_id())
        if name in PROFILER_OWN:
            own.append((start, start + e.duration_ns()))
        host.append((start, start + e.duration_ns(), name))
    if t0 is None or not d_start:
        return None
    start = np.asarray(d_start, np.int64)
    end = np.minimum(start + np.asarray(d_dur, np.int64), t1)
    start = np.maximum(start, t0)
    keep = np.flatnonzero(end > start)
    start, end = start[keep], end[keep]
    corr = np.asarray(d_corr, np.int64)[keep]
    names = [d_name[i] for i in keep]
    dur = end - start
    kernel = np.array([not n.startswith(("Memcpy", "Memset"))
                       for n in names], bool)
    graph = kernel & np.isin(corr, np.fromiter(launch_graph, np.int64))
    by_name = defaultdict(int)
    for n, t in zip(names, dur.tolist()):
        by_name[n[:_NAME]] += t

    # busy intervals: device work sorted by start, merged where it touches
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    edge = np.concatenate([[t0], reach])           # busy up to here before i
    gap_end = np.concatenate([s, [t1]])
    gaps = np.flatnonzero(gap_end > edge)
    gap_a, gap_b = edge[gaps], gap_end[gaps]
    idle_ns = int(np.sum(gap_b - gap_a))
    by_host = defaultdict(int)
    short = (gap_b - gap_a) < NAMED_GAP_NS
    if short.any():
        by_host[SHORT_GAPS] = int(np.sum((gap_b - gap_a)[short]))
    host.sort()
    starts = [h[0] for h in host]
    for a, b in zip(gap_a[~short].tolist(), gap_b[~short].tolist()):
        by_host[_innermost(host, starts, (a + b) // 2)] += b - a

    def top_of(d):
        return [(k, v * 1e-9) for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]

    return TraceSummary(window_s=(t1 - t0) * 1e-9,
                        busy_s=(t1 - t0 - idle_ns) * 1e-9,
                        kernels=int(kernel.sum()),
                        graph_kernels=int(graph.sum()),
                        graph_kernel_s=float(dur[graph].sum()) * 1e-9,
                        device_ops=top_of(by_name),
                        idle_gaps=top_of(by_host),
                        profiler_stall_s=_idle_within(
                            gap_a, gap_b, own, t0, t1) * 1e-9)


def _idle_within(gap_a, gap_b, spans, t0: int, t1: int) -> int:
    """Nanoseconds of the idle gaps [gap_a, gap_b) (sorted, disjoint) that
    fall inside the union of the host intervals ``spans``."""
    if not spans or not len(gap_a):
        return 0
    spans = sorted((max(a, t0), min(b, t1)) for a, b in spans)
    merged = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        return 0
    length = gap_b - gap_a
    before = np.concatenate([[0], np.cumsum(length)])  # idle before gap k

    def idle_until(t):
        k = np.searchsorted(gap_a, t, side="right") - 1
        inside = np.clip(t - gap_a[np.maximum(k, 0)], 0,
                         length[np.maximum(k, 0)])
        return np.where(k >= 0, before[np.maximum(k, 0)] + inside, 0)

    a, b = np.asarray(merged, np.int64).T
    return int(np.sum(idle_until(b) - idle_until(a)))


def _innermost(host, starts, t: int, look: int = 4096) -> str:
    """The latest-starting host event that covers time t: the innermost of
    nested ones."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return WINDOW
