"""Router: which execution path serves an experiment.

The JAX package's paths, all four in the port:

  * ``single`` -- one (problem, regularizer) cell through the core driver
                  (pre-sampled when the engine supports it, loop otherwise);
  * ``sweep``  -- the batched (shuffle x regularizer) grid, one program
                  over every cell (local engine, batchable grid); its inner
                  driver is named ``vmap`` as in the JAX package;
  * ``grid``   -- the same grid run cell by cell through the core driver
                  (the fallback; ``reason`` says why);
  * ``cohort`` -- the cross-device block loop over a sampled population.

The routing table is the JAX package's (``tests/test_torch_sweep.py``
mirrors its golden table), and so are its errors for fields that only the
cohort loop owns.  Every engine runs on all four paths where the JAX
package runs it: the sharded engine on ``single``, on ``grid`` (it has no
batched path) and as the cohort's inner engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.specs import Experiment

#: every route the router can choose
PATHS = ("single", "sweep", "grid", "cohort")

#: inner drivers a path can run on
INNER_DRIVERS = ("scan", "loop", "vmap")


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """The router's decision: where the experiment executes and why."""

    path: str                      # single | sweep | grid | cohort
    driver: str                    # scan | loop | vmap (inner execution)
    engine: str                    # resolved engine name
    reason: Optional[str] = None   # why a batched path was not taken


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
    engine = exp.exec.resolve_engine()
    if exp.exec.driver == "scan" and not engine.supports_scan:
        raise ValueError(
            f"engine {engine.name!r} does not support the scanned driver; "
            "use driver='auto' or 'loop'")
    inner = ("scan" if exp.exec.driver != "loop" and engine.supports_scan
             else "loop")

    kind = exp.problem.kind
    if kind == "population":
        if len(exp.method.regularizers) > 1:
            raise ValueError(
                "regularizer grids over populations are not supported; run "
                "one Experiment per grid point")
        # the cohort block loop OWNS these per-run internals (drop-schedule
        # budget_fn, expanded cohort omega0, cached-state warm starts, the
        # K-slot trace, a fresh engine per block): user-supplied ones cannot
        # apply, so dropping them silently would be a correctness trap
        owned = [("Method.budget_fn", exp.method.budget_fn),
                 ("Method.omega0", exp.method.omega0),
                 ("Exec.state0", exp.exec.state0),
                 ("Exec.mesh", exp.exec.mesh),
                 ("Exec.comm_dtype", exp.exec.comm_dtype),
                 ("Systems.trace", exp.systems.trace)]
        clash = [name for name, val in owned if val is not None]
        if clash:
            raise ValueError(
                f"{', '.join(clash)} cannot be set on a population "
                "experiment: the cohort block loop owns the budget mask, "
                "the expanded cohort Omega, warm starts, the slot trace, "
                "and the per-block engine")
        return RoutePlan(path="cohort", driver=inner, engine=engine.name)

    # the resilience knobs (fault injection, retry/degradation, block
    # checkpointing) are implemented by the cohort block loop only --
    # silently ignoring them on silo/shuffle paths would be the same
    # correctness trap as the owned-field clash above
    resilience = [("Systems.faults", exp.systems.faults is not None),
                  ("Exec.max_retries", exp.exec.max_retries != 0),
                  ("Exec.degrade", exp.exec.degrade),
                  ("Exec.checkpoint_every", exp.exec.checkpoint_every != 0),
                  ("Exec.checkpoint_dir", exp.exec.checkpoint_dir is not None),
                  ("Exec.resume", exp.exec.resume)]
    bad = [name for name, is_set in resilience if is_set]
    if bad:
        raise ValueError(
            f"{', '.join(bad)} only apply to population experiments: "
            "fault injection, retry/degradation, and checkpoint/resume "
            "live in the cohort block loop (repro_torch.cohort.resilience)")

    if kind == "shuffles" or len(exp.method.regularizers) > 1:
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
