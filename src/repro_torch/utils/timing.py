"""The port's one wall-clock access point.

Two clocks never mix: the simulated federated clock
(``core.systems_model.SystemsTrace``), the only time any result may depend
on, and the real wall clock, which only measures the implementation
(capture and build seconds, span durations).  Every wall-clock read of the
port goes through this module, as every read of the JAX package goes
through ``repro.utils.timing``; keep it free of anything but the read.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Tuple

__all__ = ["tick", "timed"]


def tick() -> float:
    """One monotonic wall-clock read (seconds); differences only."""
    return time.perf_counter()


def timed(fn: Callable[..., Any], *args: Any, **kw: Any) -> Tuple[Any, float]:
    """``(fn(*args, **kw), elapsed)`` of one call, elapsed in MICROSECONDS.

    Does not wait for the card: a caller timing device work makes ``fn``
    end in ``torch.cuda.synchronize()``.
    """
    t0 = tick()
    out = fn(*args, **kw)
    return out, (tick() - t0) * 1e6
