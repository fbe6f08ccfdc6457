"""Router: which execution path serves an experiment.

The JAX package's paths, of which the port has three:

  * ``single`` -- one (problem, regularizer) cell through the core driver
                  (pre-sampled when the engine supports it, loop otherwise);
  * ``sweep``  -- the batched (shuffle x regularizer) grid, one program
                  over every cell (local engine, batchable grid); its inner
                  driver is named ``vmap`` as in the JAX package;
  * ``grid``   -- the same grid run cell by cell through the core driver
                  (the fallback; ``reason`` says why);
  * ``cohort`` -- the cross-device path: not in the port yet.

The routing table is the JAX package's (``tests/test_torch_sweep.py``
mirrors its golden table).  An experiment that needs a path the port does
not have, or sets a field that only such a path reads, raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.specs import Eval, Exec, Experiment, Systems

#: every route of the JAX package; the port has the first three
PATHS = ("single", "sweep", "grid", "cohort")

#: inner drivers a path can run on
INNER_DRIVERS = ("scan", "loop", "vmap")

_COHORTS = "ROADMAP.md Queue 1 item 11 (checkpoint and cohort)"
_OBS = "ROADMAP.md Queue 1 item 12 (obs and serve)"
_SHARDED = "ROADMAP.md Queue 1 item 13 (sharded runtime)"

#: (spec, field) -> the ROADMAP item whose path reads it
_LATER_FIELDS = {
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

    path: str                      # single | sweep | grid
    driver: str                    # scan | loop | vmap (inner execution)
    engine: str                    # resolved engine name
    reason: Optional[str] = None   # why a batched path was not taken


def _not_yet(what: str, item: str):
    return NotImplementedError(f"{what} is not in the port yet ({item})")


def batch_incompatibility(exp: Experiment, engine) -> Optional[str]:
    """Why the batched sweep cannot serve this grid (None = it can); the
    first wall, from substrate to statistics, in the JAX package's words."""
    from repro_torch.core.sweep import grid_batch_reason
    if engine.name != "local":
        return (f"engine {engine.name!r} has no vmapped batched path; "
                "grid cells run sequentially through the core driver")
    if exp.method.budget_fn is not None:
        return "a custom budget_fn closure cannot be batched across cells"
    if exp.method.omega0 is not None or exp.exec.state0 is not None:
        return "omega0/state0 warm starts are per-run state"
    if exp.exec.driver == "loop":
        return "driver='loop' forced; the batched sweep is scan-based"
    return grid_batch_reason(exp.method.regularizers)


def route(exp: Experiment) -> RoutePlan:
    """Inspect the experiment and choose its execution path."""
    specs = {Eval: exp.eval, Systems: exp.systems, Exec: exp.exec}
    for (cls, name), item in _LATER_FIELDS.items():
        default = cls.__dataclass_fields__[name].default
        if getattr(specs[cls], name) != default:
            raise _not_yet(f"{cls.__name__}.{name}", item)
    if exp.problem.kind == "population":
        raise _not_yet("a population problem (cohort path)", _COHORTS)
    engine = exp.exec.resolve_engine()
    if exp.exec.driver == "scan" and not engine.supports_scan:
        raise ValueError(
            f"engine {engine.name!r} does not support the scanned driver; "
            "use driver='auto' or 'loop'")
    inner = ("scan" if exp.exec.driver != "loop" and engine.supports_scan
             else "loop")
    if exp.problem.kind == "shuffles" or len(exp.method.regularizers) > 1:
        if exp.systems.trace is not None:
            raise ValueError(
                "a pre-built SystemsTrace is single-run state and cannot be "
                "shared across grid cells; pass Systems(config=...) instead")
        reason = batch_incompatibility(exp, engine)
        if reason is None:
            return RoutePlan(path="sweep", driver="vmap", engine=engine.name)
        return RoutePlan(path="grid", driver=inner, engine=engine.name,
                         reason=reason)
    return RoutePlan(path="single", driver=inner, engine=engine.name)
