"""Process-local metrics registry: counters, gauges, histograms.

Instruments the cohort runtime's aggregate behaviour (blocks packed /
solved / folded, retries, degraded blocks, checkpoint bytes + latency,
merge-frontier staleness, pipeline queue depths, ``ClusterOmega`` LRU
hit rate) without touching any result: instruments only READ state, and
the whole registry is inert (``NullRegistry``) when telemetry is off.

Concurrency model: instrument creation is locked (any thread may be the
first to name a metric), but increments/observations are deliberately
unlocked -- in the cohort pipeline every metric has exactly ONE writing
thread (the same ownership discipline as the span buffers; e.g.
``blocks_packed`` is pack-worker-only, ``blocks_folded`` main-only), so
``+=``/``append`` never race.  Keep that single-writer property when
adding instruments.

``summary()`` flattens everything into one JSON-able dict (histograms as
count/total/p50/p99), which is what lands in ``Report.provenance``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Union

Number = Union[int, float]


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    if not values:
        raise ValueError("percentile of an empty value list")
    vals = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[min(rank, len(vals)) - 1])


class Counter:
    """Monotone counter; single writing thread per instance."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Append-only sample list; summarized as count/total/p50/p99."""

    __slots__ = ("name", "_values")

    def __init__(self, name: str):
        self.name = name
        self._values: List[float] = []

    def observe(self, v: Number) -> None:
        self._values.append(float(v))

    @property
    def values(self) -> List[float]:
        return list(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def total(self) -> float:
        return float(sum(self._values))

    def quantile(self, q: float) -> float:
        return percentile(self._values, q)


class MetricsRegistry:
    """Get-or-create registry of named instruments."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict, cls, name: str):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, cls(name))
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, Histogram, name)

    def summary(self) -> Dict[str, Number]:
        """One flat JSON-able dict of every instrument's current state."""
        out: Dict[str, Number] = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[f"{name}.last"] = g.value
        for name, h in sorted(self._histograms.items()):
            out[f"{name}.count"] = h.count
            if h.count:
                out[f"{name}.total"] = h.total
                out[f"{name}.p50"] = h.quantile(50)
                out[f"{name}.p99"] = h.quantile(99)
        return out


class _NullInstrument:
    """Shared no-op counter/gauge/histogram (the zero-cost off path)."""

    __slots__ = ()
    name = ""
    value: Number = 0
    count = 0
    total = 0.0

    def inc(self, n: Number = 1) -> None:
        pass

    def set(self, v: Number) -> None:
        pass

    def observe(self, v: Number) -> None:
        pass

    @property
    def values(self) -> List[float]:
        return []


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Inert registry: every instrument is the shared no-op singleton."""

    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def summary(self) -> Dict[str, Number]:
        return {}
