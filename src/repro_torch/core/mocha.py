"""MOCHA driver (Algorithm 1) plus the CoCoA special case.

The outer loop alternates federated W-update rounds (every node solves its
data-local subproblem within its step budget and ships Delta v_t; the
server reduces and recomputes W(alpha)) with a central Omega update, which
needs only W.  The round runs on a pluggable ``RoundEngine``; this driver
owns the rounds, the Omega refreshes, the budgets, the metrics and the
simulated wall clock (``SystemsTrace``).  Under the ``semi_sync`` policy
the trace caps each node's budget to what fits the clock cycle.

The port runs the JAX package's loop driver: one engine call and one host
read of the budgets per round.  The JAX package's scanned driver is
bit-identical to its loop there, so this loop is held against both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.engine import RoundEngine, get_engine
from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import Regularizer, sigma_prime
from repro_torch.core.subproblem import resolve_gram
from repro_torch.core.systems_model import SystemsConfig, SystemsTrace
from repro_torch.core.theta import (BudgetConfig, round_budgets,
                                    validate_assumption2)
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

Tensor = torch.Tensor

#: every run records exactly these history columns, each on the
#: ``record_every`` cadence
HISTORY_KEYS = ("round", "dual", "primal", "gap", "time", "round_max_steps")

DRIVERS = ("auto", "scan", "loop")


@dataclasses.dataclass(frozen=True)
class MochaConfig:
    loss: str = "hinge"
    rounds: int = 100                  # total federated W rounds
    omega_update_every: int = 0        # 0 = fixed Omega; k = every k rounds
    gamma: float = 1.0                 # aggregation parameter (Remark 3)
    per_task_sigma: bool = True        # Remark 5 per-task sigma'_t
    budget: BudgetConfig = dataclasses.field(default_factory=BudgetConfig)
    engine: str = "local"              # round executor: local | kernel
    network: str = "lte"
    systems: Optional[SystemsConfig] = None  # full systems model
    seed: int = 0
    record_every: int = 1
    driver: str = "auto"               # auto | loop (scan: not yet)
    #: per-run override of the residual-mode crossover: d <= gram_max_d
    #: selects gram mode; None defers to ``REPRO_GRAM_MAX_D`` / the default
    gram_max_d: Optional[int] = None
    #: where the run executes: None means the card
    device: Optional[str] = None


@dataclasses.dataclass
class RunResult:
    W: np.ndarray            # (m, d) final per-task models
    omega: np.ndarray        # (m, m)
    state: DualState
    history: Dict[str, List[float]]
    trace: Optional[SystemsTrace] = None        # per-node event log
    round_budgets: Optional[np.ndarray] = None  # (rounds, m) executed steps

    def final(self, key: str) -> float:
        return self.history[key][-1]


def _metrics(loss, data, state, abar, K):
    dual_val = dual_mod.dual_objective(data, loss, K, state.alpha, state.v)
    W = dual_mod.primal_weights(K, state.v)
    primal_val = dual_mod.primal_objective(data, loss, abar, W)
    return dual_val, primal_val, primal_val + dual_val


def _record_rounds(rounds: int, record_every: int) -> np.ndarray:
    """(rounds,) bool mask of history rows: every ``record_every``-th round
    and always the last."""
    if rounds < 1:
        raise ValueError(f"need rounds >= 1, got {rounds}")
    if record_every < 1:
        raise ValueError(f"need record_every >= 1, got {record_every}")
    rec = np.zeros(rounds, bool)
    rec[::record_every] = True
    rec[-1] = True
    return rec


def _coupling_terms(reg: Regularizer, omega: Tensor, gamma: float,
                    per_task_sigma: bool, m: int):
    abar = reg.coupling(omega)
    K = torch.linalg.inv(abar)
    sig = sigma_prime(K, gamma, per_task=per_task_sigma)
    q_t = sig * torch.diagonal(K) / 2.0 * torch.ones(
        m, dtype=K.dtype, device=K.device)
    return abar, K, q_t


def _on(x, dev) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _run_mocha(data: FederatedData, reg: Regularizer, cfg: MochaConfig,
               omega0=None,
               budget_fn: Optional[Callable[[Tensor, Tensor, int],
                                            Tensor]] = None,
               engine=None,
               trace: Optional[SystemsTrace] = None,
               state0: Optional[DualState] = None) -> RunResult:
    """Run Algorithm 1 on the configured round engine.

    ``budget_fn(key, n_t, round) -> (m,) int budgets`` overrides the
    BudgetConfig sampler; ``engine`` overrides ``cfg.engine`` (a name,
    class or instance); ``trace`` continues a SystemsTrace; ``omega0`` and
    ``state0`` (alpha, v with v = X alpha) warm-start the run.  The data
    and the warm starts move to ``cfg.device``.
    """
    loss = get_loss(cfg.loss)
    validate_assumption2(cfg.budget)
    if cfg.driver not in DRIVERS:
        raise ValueError(f"driver {cfg.driver!r} not in {DRIVERS}")
    if cfg.driver == "scan":
        raise NotImplementedError(
            "driver='scan' is not in the port yet (ROADMAP.md Queue 1 item "
            "8: the pre-sampled driver); use driver='auto' or 'loop'")
    dev = resolve_device(cfg.device)
    eng = get_engine(engine if engine is not None else cfg.engine)
    # the row-norm table is computed once per run and read by every round
    data = dual_mod.with_xnorm2(data.to(dev))
    m = data.m
    omega = (reg.init_omega(m, device=dev) if omega0 is None
             else _on(omega0, dev))
    abar, K, q_t = _coupling_terms(reg, omega, cfg.gamma, cfg.per_task_sigma,
                                   m)
    max_steps = cfg.budget.max_steps(data.n_max)
    gram = resolve_gram(data.d, cfg.gram_max_d)
    state = eng.setup(data, loss, max_steps, gram=gram)
    if state0 is not None:
        state = DualState(alpha=_on(state0.alpha, dev), v=_on(state0.v, dev))
    if trace is None:
        trace = SystemsTrace(m, data.d,
                             cfg.systems or SystemsConfig(network=cfg.network))
    return _run_loop(data, reg, cfg, loss, eng, trace, state, omega, abar, K,
                     q_t, max_steps, budget_fn)


def _run_loop(data, reg, cfg, loss, eng: RoundEngine, trace, state, omega,
              abar, K, q_t, max_steps, budget_fn) -> RunResult:
    """The round loop: one engine call and one host read per round."""
    m = data.m
    key = prng.PRNGKey(cfg.seed, device=data.device)
    record = _record_rounds(cfg.rounds, cfg.record_every)
    history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
    budgets_log: List[np.ndarray] = []

    for h in range(cfg.rounds):
        key, k_budget, k_round = prng.split(key, 3)
        if budget_fn is not None:
            budgets = budget_fn(k_budget, data.n_t, h)
        else:
            budgets = round_budgets(cfg.budget, k_budget, data.n_t)
        budgets = torch.clamp_max(budgets, max_steps)
        cap = trace.begin_round()
        if cap is not None:   # semi_sync: fit the work to the clock cycle
            cap = np.minimum(cap, max_steps)
            budgets = torch.minimum(budgets, torch.as_tensor(
                cap, dtype=budgets.dtype, device=budgets.device))
        state = eng.round(state, K, q_t, budgets, cfg.gamma, k_round)
        steps_np = budgets.cpu().numpy()
        trace.commit(steps_np)
        budgets_log.append(steps_np.astype(np.int64))

        if cfg.omega_update_every and (h + 1) % cfg.omega_update_every == 0:
            W = dual_mod.primal_weights(K, state.v)
            omega = reg.update_omega(W, omega)
            # Omega changed, so the dual problem did: v = X alpha stays,
            # W(alpha) and the objectives take the new K
            abar, K, q_t = _coupling_terms(reg, omega, cfg.gamma,
                                           cfg.per_task_sigma, m)

        if record[h]:
            dual_val, primal_val, gap = _metrics(loss, data, state, abar, K)
            history["round"].append(h)
            history["dual"].append(float(dual_val))
            history["primal"].append(float(primal_val))
            history["gap"].append(float(gap))
            history["time"].append(trace.elapsed_s)
            history["round_max_steps"].append(int(steps_np.max()))

    W = dual_mod.primal_weights(K, state.v)
    return RunResult(W=W.cpu().numpy(), omega=omega.cpu().numpy(),
                     state=state, history=history, trace=trace,
                     round_budgets=np.stack(budgets_log))


def run_cocoa(data: FederatedData, reg: Regularizer, cfg: MochaConfig,
              omega0=None) -> RunResult:
    """CoCoA baseline: MOCHA with a uniform, fixed approximation quality.

    Every node runs ``passes`` full passes over its data each round
    regardless of systems state (no clock cycle, no drops), so the
    synchronous round waits for the slowest node (paper Sec. 3.4).
    """
    fixed = BudgetConfig(passes=cfg.budget.passes)
    systems = cfg.systems
    if systems is not None and systems.policy != "sync":
        # CoCoA has no clock cycle: keep the hardware model, drop the
        # deadline
        systems = dataclasses.replace(systems, policy="sync",
                                      clock_cycle_s=0.0)
    cocoa_cfg = dataclasses.replace(cfg, budget=fixed, per_task_sigma=False,
                                    systems=systems)
    return _run_mocha(data, reg, cocoa_cfg, omega0=omega0)
