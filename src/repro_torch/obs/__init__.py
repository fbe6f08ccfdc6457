"""repro_torch.obs: deterministic-safe runtime telemetry (spans + metrics).

The port's copy of the JAX package's ``repro.obs`` (which imports no JAX
either; the port keeps its own copy because it imports nothing of
``repro``):

  * span tracing (``tracer``) with lock-free per-worker buffers,
    recording real wall time AND the simulated clock on every span;
  * a counters/gauges/histograms registry (``metrics``);
  * Chrome trace-event export (``export``) -- one track per pipeline
    worker plus a virtual simulated-clock track -- and a flat metrics
    summary merged into ``Report.provenance``;
  * ``python -m repro_torch.obs.summarize trace.json`` for browserless
    reading.

THE DETERMINISM CONTRACT: telemetry reads state, never draws RNG, never
charges the simulated clock, and never reads the card (no synchronize, no
host copy): results are bit-identical with telemetry on or off, and the off
path is a handful of no-op calls on shared null singletons.  A span around
device work therefore times the host's enqueue of it, not its execution.

Construct telemetry only through this module (``telemetry()`` /
``NULL_TELEMETRY``).  Turn it on with ``Exec(telemetry=True)``
(``Exec.trace_dir`` additionally writes the Chrome trace JSON).
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.obs.export import (metrics_summary, to_chrome_trace,
                                    validate_chrome_trace, wall_extent,
                                    write_trace)
from repro_torch.obs.metrics import MetricsRegistry, NullRegistry
from repro_torch.obs.tracer import NullTracer, Tracer

__all__ = ["Telemetry", "NULL_TELEMETRY", "telemetry", "metrics_summary",
           "to_chrome_trace", "validate_chrome_trace", "wall_extent",
           "write_trace"]


class Telemetry:
    """One run's telemetry: a tracer + registry, viewed from one worker.

    ``for_worker`` returns a cheap view whose spans/events land on that
    worker's track -- the driver hands its pack/solve stages their own
    views so every record is attributed to the thread role that made it.
    All views share the same underlying tracer and registry.
    """

    __slots__ = ("tracer", "metrics", "worker")

    def __init__(self, tracer: Any, metrics: Any, worker: str = "main"):
        self.tracer = tracer
        self.metrics = metrics
        self.worker = worker

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def for_worker(self, worker: str) -> "Telemetry":
        if not self.tracer.enabled:
            return self
        return Telemetry(self.tracer, self.metrics, worker)

    def set_sim_clock(self, fn: Callable[[], float]) -> None:
        """Bind the simulated-clock READ (e.g. ``lambda: trace.elapsed_s``)."""
        self.tracer.set_sim_clock(fn)

    # -- delegates (one attribute hop; no-ops end on null singletons) -------

    def span(self, name: str, **args: Any):
        return self.tracer.span(name, worker=self.worker, **args)

    def event(self, name: str, **args: Any) -> None:
        self.tracer.event(name, worker=self.worker, **args)

    def counter(self, name: str):
        return self.metrics.counter(name)

    def gauge(self, name: str):
        return self.metrics.gauge(name)

    def histogram(self, name: str):
        return self.metrics.histogram(name)


#: the shared inert instance every off-path call site bottoms out in
NULL_TELEMETRY = Telemetry(NullTracer(), NullRegistry())


def telemetry(enabled: bool = True) -> Telemetry:
    """A recording Telemetry when ``enabled``, else ``NULL_TELEMETRY``."""
    if not enabled:
        return NULL_TELEMETRY
    return Telemetry(Tracer(), MetricsRegistry())
