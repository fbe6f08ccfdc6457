"""Declarative experiment specs: the port's one surface for a MOCHA run.

``Experiment`` is composed of five sub-specs, as in the JAX package's
``repro.api``:

  * ``Problem`` -- what is solved (one cross-silo federation);
  * ``Method``  -- loss, regularizer, rounds, budgets, Omega schedule;
  * ``Systems`` -- the simulated systems environment;
  * ``Exec``    -- how it executes: engine, driver, crossover, device;
  * ``Eval``    -- the history cadence.

``Experiment.run(seed)`` routes (``router.route``) and runs it
(``execute.run_experiment``).  This slice of the port runs the single path;
the fields of the other paths (shuffle grids, populations, resilience,
telemetry, held-out evaluation) exist with the JAX package's defaults, and
setting one raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

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
    clock.  ``sampler``, ``dropout`` and ``faults`` belong to populations."""

    network: str = "lte"
    config: Optional[SystemsConfig] = None
    trace: Optional[SystemsTrace] = None
    sampler: str = "uniform"
    dropout: float = 0.0
    faults: Optional[Any] = None

    @property
    def policy(self) -> str:
        return self.config.policy if self.config is not None else "sync"


@dataclasses.dataclass(frozen=True)
class Exec:
    """How the experiment executes.

    ``engine`` is ``"local"`` (plain PyTorch solver, every loss),
    ``"kernel"`` (the Hopper SDCA kernel, hinge) or an engine instance;
    ``device`` is where the run executes (``"cuda"`` unless the caller asks
    for ``"cpu"``); ``state0`` warm-starts the dual iterate.  The other
    fields are those of the JAX package's other paths.
    """

    engine: Any = "local"
    driver: str = "auto"               # auto | loop
    gram_max_d: Optional[int] = None
    device: str = "cuda"
    state0: Optional[DualState] = None
    mesh: Any = None
    comm_dtype: Any = None
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

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"driver {self.driver!r} not in {DRIVERS}")

    def resolve_engine(self):
        from repro_torch.core.engine import get_engine
        return get_engine(self.engine)

    @property
    def engine_name(self) -> str:
        if isinstance(self.engine, str):
            return self.engine
        return getattr(self.engine, "name", "local")


@dataclasses.dataclass(frozen=True)
class Eval:
    """What is measured: the history cadence, and (in later slices) the
    held-out split or held-out clients."""

    record_every: int = 1
    holdout: Optional[Any] = None
    holdout_clients: int = 0
    metrics: Tuple[str, ...] = ("error", "loss")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A fully described experiment; ``run(seed)`` executes it."""

    problem: Problem
    method: Method = Method()
    systems: Systems = Systems()
    exec: Exec = Exec()
    eval: Eval = Eval()

    def run(self, seed: int = 0) -> "Report":
        from repro_torch.api.execute import run_experiment
        return run_experiment(self, seed)

    def serve(self, seed: int = 0, serve=None):
        raise NotImplementedError(
            "Experiment.serve is not in the port yet (ROADMAP.md Queue 1 "
            "item 12: obs/ and serve/)")

    def route(self) -> "RoutePlan":
        from repro_torch.api.router import route
        return route(self)


def as_mocha_config(exp: Experiment, seed: int = 0) -> MochaConfig:
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
        record_every=exp.eval.record_every,
        driver=exp.exec.driver,
        gram_max_d=exp.exec.gram_max_d,
        device=exp.exec.device,
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
    if callable(x):
        return getattr(x, "__qualname__", type(x).__name__)
    return type(x).__name__


def config_fingerprint(exp: Experiment) -> str:
    """Stable 12-hex-digit hash of the experiment description."""
    blob = json.dumps(_canon(exp), sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
