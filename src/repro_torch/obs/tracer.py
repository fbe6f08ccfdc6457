"""Span tracing with lock-free per-worker buffers and two clock columns.

A ``Span`` records one named interval (or instant event) on one pipeline
worker, with BOTH clock domains side by side:

  * real wall time, read exclusively through ``repro_torch.utils.timing.
    tick`` (the port's one wall-clock module), because telemetry measures
    the *implementation*;
  * the simulated ``SystemsTrace`` clock, sampled through an injected
    ``sim_clock`` callable, because the interesting question is always
    "where did the wall time go RELATIVE to the simulated federated time".

The tracer is deterministic-safe by construction: it only ever READS state
-- ``sim_clock`` must be a pure read (``trace.elapsed_s``), never a draw or
a charge -- so tracing on/off cannot perturb results (pinned by the on-vs-off
bit-identity tests).

Lock-free buffers: spans are bucketed per worker name, and the cohort
pipeline's ownership contract (repro_torch.cohort.driver._BlockLoop: one pack
worker, one solve worker, the main thread) guarantees each bucket is only
ever appended to by the single thread playing that role.  ``dict.setdefault``
and ``list.append`` are single-bytecode atomic under the GIL, so no lock is
needed on the hot path; ``spans()`` copies, so readers never observe a
buffer mid-mutation.

``NullTracer`` is the off-path: every operation is a constant-time no-op on
shared singletons, so an instrumented call site costs one attribute lookup
and one no-op call when telemetry is disabled.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.utils.timing import tick

#: the known worker roles, in display order: the cohort pipeline's three
#: stages plus the serve tier's reader role; unknown worker names are
#: legal (export assigns them tracks after these)
WORKERS = ("main", "pack", "solve", "serve")


@dataclasses.dataclass
class Span:
    """One traced interval (``dur_s`` set) or instant event (``dur_s`` None).

    ``ts_s``/``dur_s`` are wall seconds from ``utils.timing.tick`` (a
    monotonic origin, differences only); ``sim_ts_s``/``sim_dur_s`` are the
    simulated clock's seconds at entry / elapsed across the span (None when
    no ``sim_clock`` was bound).  ``args`` is a small JSON-able tag dict
    (block index, attempt, staleness, ...).
    """

    name: str
    worker: str
    ts_s: float = 0.0
    dur_s: Optional[float] = None
    sim_ts_s: Optional[float] = None
    sim_dur_s: Optional[float] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _SpanCtx:
    """Context manager for one in-flight span; ``set(**tags)`` adds args."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def set(self, **tags: Any) -> "_SpanCtx":
        self._span.args.update(tags)
        return self

    def __enter__(self) -> "_SpanCtx":
        sim = self._tracer._sim_clock
        if sim is not None:
            self._span.sim_ts_s = float(sim())
        self._span.ts_s = tick()
        return self

    def __exit__(self, *exc: Any) -> bool:
        sp = self._span
        sp.dur_s = tick() - sp.ts_s
        sim = self._tracer._sim_clock
        if sim is not None and sp.sim_ts_s is not None:
            sp.sim_dur_s = float(sim()) - sp.sim_ts_s
        self._tracer._append(sp)
        return False


class Tracer:
    """Recording tracer: per-worker append-only span buffers."""

    enabled = True

    def __init__(self, sim_clock: Optional[Callable[[], float]] = None):
        self._sim_clock = sim_clock
        self.origin_s = tick()
        self._buffers: Dict[str, List[Span]] = {}

    def set_sim_clock(self, fn: Callable[[], float]) -> None:
        """Bind the simulated-clock read (e.g. ``lambda: trace.elapsed_s``).

        Must be a pure READ of the simulated clock -- never a draw, never a
        charge; binding may happen after construction because the
        ``SystemsTrace`` usually exists only once the run is set up.
        """
        self._sim_clock = fn

    def span(self, name: str, worker: str = "main", **args: Any) -> _SpanCtx:
        return _SpanCtx(self, Span(name=name, worker=worker, args=dict(args)))

    def event(self, name: str, worker: str = "main", **args: Any) -> None:
        """Record an instant event (a zero-duration span)."""
        sim = self._sim_clock
        self._append(Span(
            name=name, worker=worker, ts_s=tick(),
            sim_ts_s=float(sim()) if sim is not None else None,
            args=dict(args)))

    def _append(self, span: Span) -> None:
        # setdefault + append are GIL-atomic; each worker-name bucket has
        # exactly one appending thread (the pipeline ownership contract)
        self._buffers.setdefault(span.worker, []).append(span)

    def spans(self) -> Dict[str, List[Span]]:
        """{worker -> spans in record order}; copied, safe to iterate."""
        return {w: list(buf) for w, buf in self._buffers.items()}

    def count(self, name: str) -> int:
        """How many spans/events named ``name`` were recorded (all workers)."""
        return sum(1 for buf in self._buffers.values()
                   for sp in buf if sp.name == name)


class _NullSpanCtx:
    """Shared no-op span context (the zero-cost off path)."""

    __slots__ = ()

    def set(self, **tags: Any) -> "_NullSpanCtx":
        return self

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpanCtx()


class NullTracer:
    """Inert tracer: every method is a no-op returning shared singletons."""

    enabled = False

    def set_sim_clock(self, fn: Callable[[], float]) -> None:
        pass

    def span(self, name: str, worker: str = "main",
             **args: Any) -> _NullSpanCtx:
        return _NULL_SPAN

    def event(self, name: str, worker: str = "main", **args: Any) -> None:
        pass

    def spans(self) -> Dict[str, List[Span]]:
        return {}

    def count(self, name: str) -> int:
        return 0
