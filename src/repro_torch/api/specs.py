"""Declarative experiment specs: the port's one surface for a MOCHA run.

``Experiment`` is composed of five sub-specs, as in the JAX package's
``repro.api``:

  * ``Problem`` -- what is solved: one cross-silo federation, a stack of
                   shuffles, or a streaming client population;
  * ``Method``  -- loss, regularizer, rounds, budgets, Omega schedule;
  * ``Systems`` -- the simulated systems environment: network, clock,
                   cohort sampling and dropout, fault injection;
  * ``Exec``    -- how it executes: engine, driver, crossover, cohort and
                   cache sizes, resilience, telemetry, device;
  * ``Eval``    -- the history cadence and the held-out split or clients.

``Experiment.run(seed)`` routes (``router.route``) and runs it
(``execute.run_experiment``) on the single, sweep, grid or cohort path.
``Experiment.serve(seed, Serve(...))`` (``execute.serve_experiment``)
attaches the online prediction tier to a population's cohort run.
``as_mocha_config`` / ``as_cohort_config`` build the drivers' configs from
the specs.  ``Exec.mesh``/``comm_dtype`` configure the sharded engine.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.cohort.resilience import FaultConfig
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.mocha import DRIVERS, MochaConfig
from repro_torch.core.regularizers import MeanRegularized, Regularizer
from repro_torch.core.systems_model import SystemsConfig, SystemsTrace
from repro_torch.core.theta import BudgetConfig

#: the problem shapes the router distinguishes
PROBLEM_KINDS = ("silo", "shuffles", "population")


@dataclasses.dataclass(frozen=True)
class Problem:
    """What is solved: exactly one of ``train`` (a federation, or a
    sequence or (S, m, n, d) stack of shuffles) or ``population``."""

    train: Optional[Union[FederatedData, Sequence[FederatedData]]] = None
    population: Optional[Any] = None

    def __post_init__(self):
        if (self.train is None) == (self.population is None):
            raise ValueError(
                "Problem needs exactly one of train= or population=")
        if self.train is not None and not isinstance(self.train,
                                                     FederatedData):
            object.__setattr__(self, "train", tuple(self.train))
        if isinstance(self.train, FederatedData) and self.train.X.ndim not in (
                3, 4):
            raise ValueError(
                "Problem.train expects (m, n, d) or stacked (S, m, n, d) "
                f"data; got X of shape {tuple(self.train.X.shape)}")

    @property
    def kind(self) -> str:
        if self.population is not None:
            return "population"
        if not isinstance(self.train, FederatedData) or self.train.X.ndim == 4:
            return "shuffles"
        return "silo"

    @property
    def d(self) -> int:
        """Feature dimension (drives the gram/carry residual mode)."""
        if self.population is not None:
            return int(self.population.spec.d)
        first = (self.train if isinstance(self.train, FederatedData)
                 else self.train[0])
        return int(first.X.shape[-1])

    def stacked(self) -> FederatedData:
        """The (S, m, n, d) stacked view of the shuffle axis."""
        from repro_torch.core.sweep import stack_federations
        if not isinstance(self.train, FederatedData):
            return stack_federations(self.train)
        if self.train.X.ndim == 3:
            return stack_federations([self.train])
        return self.train

    def shuffle_list(self) -> Tuple[FederatedData, ...]:
        """Per-shuffle (m, n, d) federations (the grid path's view): a
        sequence as given (unpadded), a stack sliced (its padding is inert
        under the masks)."""
        if not isinstance(self.train, FederatedData):
            return self.train
        if self.train.X.ndim == 3:
            return (self.train,)
        t = self.train
        return tuple(
            FederatedData(X=t.X[s], y=t.y[s], mask=t.mask[s],
                          xnorm2=None if t.xnorm2 is None else t.xnorm2[s])
            for s in range(t.X.shape[0]))


@dataclasses.dataclass(frozen=True)
class Method:
    """The statistical method and its schedule.  ``budget_fn(key, n_t,
    round) -> (m,) budgets`` overrides the BudgetConfig sampler; ``omega0``
    fixes the initial relationship matrix."""

    loss: str = "hinge"
    regularizers: Union[Regularizer, Tuple[Regularizer, ...]] = (
        MeanRegularized(),)
    rounds: int = 100
    omega_update_every: int = 0        # 0 = fixed Omega
    gamma: float = 1.0
    per_task_sigma: bool = True
    budget: BudgetConfig = dataclasses.field(default_factory=BudgetConfig)
    budget_fn: Optional[Callable] = None
    omega0: Optional[Any] = None       # initial (m, m) relationship

    def __post_init__(self):
        regs = self.regularizers
        if isinstance(regs, Regularizer):
            regs = (regs,)
        regs = tuple(regs)
        if not regs:
            raise ValueError("Method needs at least one regularizer")
        object.__setattr__(self, "regularizers", regs)


@dataclasses.dataclass(frozen=True)
class Systems:
    """The simulated systems environment.  ``config`` (the event-driven
    model) overrides ``network``; ``trace`` continues a SystemsTrace's
    clock (single runs).  ``sampler`` / ``dropout`` describe cross-device
    participation and ``faults`` the deterministic fault schedule of the
    cohort block loop (population problems only)."""

    network: str = "lte"
    config: Optional[SystemsConfig] = None
    trace: Optional[SystemsTrace] = None
    sampler: str = "uniform"
    dropout: float = 0.0
    faults: Optional[FaultConfig] = None

    @property
    def policy(self) -> str:
        return self.config.policy if self.config is not None else "sync"


@dataclasses.dataclass(frozen=True)
class Exec:
    """How the experiment executes.

    ``engine`` is ``"local"`` (plain PyTorch solver, every loss),
    ``"kernel"`` (the Hopper SDCA kernel, hinge), ``"sharded"`` (tasks
    sharded over the ranks of a process group) or an engine instance;
    ``state0`` warm-starts the dual iterate; ``cohort`` ... ``resume`` are
    the cohort block loop's (population problems); ``telemetry`` records
    spans and metrics and ``trace_dir`` writes their Chrome trace (every
    path).  The fields are the JAX package's, in its order, then
    ``device``: where the run executes (``"cuda"`` unless the caller asks
    for ``"cpu"``).  ``mesh`` (a 1-D ``DeviceMesh``) and ``comm_dtype`` (the
    Delta v wire's dtype: a ``torch.dtype`` or its name, ``"bfloat16"``)
    configure the sharded engine.
    """

    engine: Any = "local"
    driver: str = "auto"               # auto | scan | loop
    gram_max_d: Optional[int] = None
    mesh: Any = None
    comm_dtype: Any = None
    state0: Optional[DualState] = None
    cohort: int = 64
    inner_rounds: int = 1
    clusters: int = 3
    eta: float = 0.5
    cache_clients: int = 4096
    n_pad: Optional[int] = None
    overlap: int = 1
    staleness: int = 0
    max_retries: int = 0
    degrade: bool = False
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    telemetry: bool = False
    trace_dir: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"driver {self.driver!r} not in {DRIVERS}")
        if self.overlap < 1:
            raise ValueError(f"need overlap >= 1, got {self.overlap}")
        if self.staleness < 0:
            raise ValueError(f"need staleness >= 0, got {self.staleness}")
        if self.max_retries < 0:
            raise ValueError(
                f"need max_retries >= 0, got {self.max_retries}")
        if self.checkpoint_every < 0:
            raise ValueError(
                f"need checkpoint_every >= 0, got {self.checkpoint_every}")
        if ((self.checkpoint_every > 0 or self.resume)
                and self.checkpoint_dir is None):
            raise ValueError(
                "checkpoint_every/resume need Exec.checkpoint_dir")

    def resolve_engine(self):
        """Instantiate the engine (mesh/comm_dtype configure 'sharded')."""
        from repro_torch.core.engine import ShardedEngine, get_engine
        if (self.engine == "sharded"
                and (self.mesh is not None or self.comm_dtype is not None)):
            return ShardedEngine(mesh=self.mesh, comm_dtype=self.comm_dtype)
        return get_engine(self.engine)

    @property
    def engine_name(self) -> str:
        if isinstance(self.engine, str):
            return self.engine
        return getattr(self.engine, "name", "local")


@dataclasses.dataclass(frozen=True)
class Eval:
    """What is measured: the history cadence, and the held-out split.

    ``holdout`` is a test ``FederatedData`` matching the problem (stacked,
    or a sequence, for shuffle grids); when set, the Report carries a
    per-client table of ``metrics``.  ``holdout_clients`` is the
    population analogue: how many never- (or least-) trained clients to
    materialize and score, by learned cluster.
    """

    record_every: int = 1
    holdout: Optional[Union[FederatedData, Sequence[FederatedData]]] = None
    holdout_clients: int = 0
    metrics: Tuple[str, ...] = ("error", "loss")

    def holdout_stacked(self) -> Optional[FederatedData]:
        """The held-out split as (S, m, n, d), or None."""
        from repro_torch.core.sweep import stack_federations
        if self.holdout is None:
            return None
        if not isinstance(self.holdout, FederatedData):
            return stack_federations(tuple(self.holdout))
        if self.holdout.X.ndim == 3:
            return stack_federations([self.holdout])
        return self.holdout


@dataclasses.dataclass(frozen=True)
class Serve:
    """Online-serving sub-spec for ``Experiment.serve()``.

    ``publish_every`` is the snapshot refresh cadence in folded blocks (1 =
    every fold publishes).  ``prewarm`` publishes the deterministic cold
    state as version 0 before training starts, so predictions are
    answerable from t=0 (cold clients resolve to their cluster centroid).
    Serving never changes training: a run with a ``ServeSession`` attached
    gives the bits of ``Experiment.run``, as ``Exec.telemetry`` does.
    """

    publish_every: int = 1
    prewarm: bool = True

    def __post_init__(self):
        if self.publish_every < 1:
            raise ValueError(
                f"need publish_every >= 1 folds, got {self.publish_every}")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A fully described experiment; ``run(seed)`` executes it,
    ``serve(seed)`` serves it while it trains (populations only)."""

    problem: Problem
    method: Method = Method()
    systems: Systems = Systems()
    exec: Exec = Exec()
    eval: Eval = Eval()

    def run(self, seed: int = 0) -> "Report":
        from repro_torch.api.execute import run_experiment
        return run_experiment(self, seed)

    def serve(self, seed: int = 0,
              serve: Optional[Serve] = None) -> "ServeSession":
        """An online ``repro_torch.serve.ServeSession`` over this
        experiment: cohort training streams in the background (``start()``
        / ``join()``, or inline ``run()``) while ``predict(ids, X)``
        answers from atomically swapped snapshots, on the run's device.
        Cohort-routed populations only."""
        from repro_torch.api.execute import serve_experiment
        return serve_experiment(self, seed, serve)

    def route(self) -> "RoutePlan":
        from repro_torch.api.router import route
        return route(self)


def as_mocha_config(exp: Experiment, seed: int = 0, *,
                    record_every: Optional[int] = None) -> MochaConfig:
    """``MochaConfig`` as a frozen view over (Method, Systems, Exec, Eval):
    the one wiring point between the specs and the driver."""
    return MochaConfig(
        loss=exp.method.loss,
        rounds=exp.method.rounds,
        omega_update_every=exp.method.omega_update_every,
        gamma=exp.method.gamma,
        per_task_sigma=exp.method.per_task_sigma,
        budget=exp.method.budget,
        engine=exp.exec.engine_name,
        network=exp.systems.network,
        systems=exp.systems.config,
        seed=int(seed),
        record_every=(exp.eval.record_every if record_every is None
                      else record_every),
        driver=exp.exec.driver,
        gram_max_d=exp.exec.gram_max_d,
        device=exp.exec.device,
    )


def as_cohort_config(exp: Experiment, seed: int = 0):
    """``CohortConfig`` as a frozen view over the sub-specs; its ``inner``
    per-block solver settings are an ``as_mocha_config`` view (the cohort
    loop owns the inner systems clock, so ``inner.systems`` is None)."""
    from repro_torch.cohort.driver import CohortConfig
    inner = dataclasses.replace(as_mocha_config(exp, seed=seed), systems=None)
    return CohortConfig(
        rounds=exp.method.rounds,
        cohort=exp.exec.cohort,
        inner_rounds=exp.exec.inner_rounds,
        sampler=exp.systems.sampler,
        dropout=exp.systems.dropout,
        clusters=exp.exec.clusters,
        eta=exp.exec.eta,
        omega_update_every=exp.method.omega_update_every,
        cache_clients=exp.exec.cache_clients,
        network=exp.systems.network,
        systems=exp.systems.config,
        seed=int(seed),
        record_every=exp.eval.record_every,
        n_pad=exp.exec.n_pad,
        overlap=exp.exec.overlap,
        staleness=exp.exec.staleness,
        max_retries=exp.exec.max_retries,
        degrade=exp.exec.degrade,
        faults=exp.systems.faults,
        checkpoint_every=exp.exec.checkpoint_every,
        checkpoint_dir=exp.exec.checkpoint_dir,
        resume=exp.exec.resume,
        telemetry=bool(exp.exec.telemetry or exp.exec.trace_dir is not None),
        trace_dir=exp.exec.trace_dir,
        inner=inner,
    )


def _canon(x) -> Any:
    """Canonical JSON-able form of a spec tree for hashing: tensors and
    arrays count by shape and dtype, runtime objects by name."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {"__class__": type(x).__name__}
        for f in dataclasses.fields(x):
            out[f.name] = _canon(getattr(x, f.name))
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):   # NamedTuple
        return {"__class__": type(x).__name__,
                **{k: _canon(v) for k, v in zip(x._fields, x)}}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in sorted(x.items())}
    if hasattr(x, "shape") and hasattr(x, "dtype"):      # tensor / ndarray
        return ["array", [int(s) for s in x.shape], str(x.dtype)]
    if isinstance(x, np.dtype) or isinstance(x, type):
        return str(getattr(x, "__name__", x))
    if isinstance(x, torch.dtype):                        # the wire dtype
        return str(x).removeprefix("torch.")
    if callable(x):
        return getattr(x, "__qualname__", type(x).__name__)
    return type(x).__name__


def config_fingerprint(exp: Experiment) -> str:
    """Stable 12-hex-digit hash of the experiment description."""
    blob = json.dumps(_canon(exp), sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
