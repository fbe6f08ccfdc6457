"""Router: which execution path serves an experiment.

The JAX package routes an experiment to one of four paths (``single``,
``sweep``, ``grid``, ``cohort``).  This slice of the port has the
``single`` path: one (problem, regularizer) run through the loop driver.
An experiment that needs another path, or sets a field that only another
path reads, raises ``NotImplementedError`` naming the ROADMAP item that
ports it, rather than being run some other way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.specs import Eval, Exec, Experiment, Systems

#: every route of the JAX package; the port has the first
PATHS = ("single", "sweep", "grid", "cohort")

_GRIDS = "ROADMAP.md Queue 1 item 10 (evaluate, minibatch, sweep)"
_COHORTS = "ROADMAP.md Queue 1 item 11 (checkpoint and cohort)"
_OBS = "ROADMAP.md Queue 1 item 12 (obs and serve)"
_SHARDED = "ROADMAP.md Queue 1 item 13 (sharded runtime)"

#: (spec, field) -> the ROADMAP item whose path reads it
_LATER_FIELDS = {
    (Eval, "holdout"): _GRIDS,
    (Eval, "holdout_clients"): _COHORTS,
    (Systems, "sampler"): _COHORTS,
    (Systems, "dropout"): _COHORTS,
    (Systems, "faults"): _COHORTS,
    **{(Exec, f): _COHORTS for f in (
        "cohort", "inner_rounds", "clusters", "eta", "cache_clients", "n_pad",
        "overlap", "staleness", "max_retries", "degrade", "checkpoint_every",
        "checkpoint_dir", "resume")},
    (Exec, "telemetry"): _OBS,
    (Exec, "trace_dir"): _OBS,
    (Exec, "mesh"): _SHARDED,
    (Exec, "comm_dtype"): _SHARDED,
}


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """The router's decision: where the experiment executes and why."""

    path: str                      # single
    driver: str                    # loop
    engine: str                    # resolved engine name
    reason: Optional[str] = None   # why a batched path was not taken


def _not_yet(what: str, item: str):
    return NotImplementedError(f"{what} is not in the port yet ({item})")


def route(exp: Experiment) -> RoutePlan:
    """Inspect the experiment and choose its execution path."""
    specs = {Eval: exp.eval, Systems: exp.systems, Exec: exp.exec}
    for (cls, name), item in _LATER_FIELDS.items():
        default = cls.__dataclass_fields__[name].default
        if getattr(specs[cls], name) != default:
            raise _not_yet(f"{cls.__name__}.{name}", item)
    if exp.problem.kind == "population":
        raise _not_yet("a population problem (cohort path)", _COHORTS)
    if exp.problem.kind == "shuffles" or len(exp.method.regularizers) > 1:
        raise _not_yet("a shuffle or regularizer grid (sweep/grid path)",
                       _GRIDS)
    engine = exp.exec.resolve_engine()
    if exp.exec.driver == "scan":
        raise _not_yet("driver='scan'",
                       "ROADMAP.md Queue 1 item 8 (pre-sampled driver)")
    return RoutePlan(path="single", driver="loop", engine=engine.name)
