"""The experiment result: the run's payload, held-out evaluation and
provenance."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

#: keys every provenance block carries: the JAX package's, with ``backend``
#: the torch device type, plus the device and the card's name
PROVENANCE_KEYS = ("path", "driver", "engine", "fallback_reason",
                   "gram_max_d", "gram_mode", "config_hash", "backend",
                   "device", "device_name", "retries", "degraded_blocks",
                   "telemetry", "trace_path")


@dataclasses.dataclass
class Report:
    """What ``Experiment.run`` hands back: ``result`` is the driver's
    ``RunResult`` (single path), a ``SweepResult`` (sweep and grid paths)
    or a ``CohortRunResult`` (cohort path: the factored state, per-block
    history, schedule, participation and fault accounting);
    ``provenance`` records how the run executed (the router's path, inner
    driver and fallback reason among it; the cohort path's ``retries`` and
    ``degraded_blocks``; the telemetry summary and trace path);
    ``evaluation`` is the held-out ``EvalReport`` when ``Eval.holdout`` or
    ``Eval.holdout_clients`` is set."""

    result: Any
    provenance: Dict[str, Any]
    evaluation: Optional[Any] = None

    @property
    def history(self) -> Optional[Dict]:
        return getattr(self.result, "history", None)

    @property
    def trace(self):
        return getattr(self.result, "trace", None)

    def final(self, key: str) -> float:
        """Last recorded value of a history column."""
        return self.result.final(key)
