"""MOCHA driver (Algorithm 1) plus the CoCoA special case.

The outer loop alternates federated W-update rounds (every node solves its
data-local subproblem within its step budget and ships Delta v_t; the
server reduces and recomputes W(alpha)) with a central Omega update, which
needs only W.  The round runs on a pluggable ``RoundEngine``; this driver
owns the rounds, the Omega refreshes, the budgets, the metrics and the
simulated wall clock (``SystemsTrace``).  Under the ``semi_sync`` policy
the trace caps each node's budget to what fits the clock cycle.

Two drivers run the same W-round loop, as in the JAX package:

  * the **loop driver** steps rounds from Python: one engine call and one
    host read of the budgets per round (every engine);
  * the **pre-sampled ("scanned") driver** (engines with
    ``supports_scan``) draws the whole (rounds, m) budget matrix and the
    round keys up front (budgets and semi_sync caps are round-indexed, never
    state-dependent), runs every round through one ``RoundProgram`` -- on a
    CUDA device a CUDA graph captured once and replayed, the counterpart of
    XLA compiling the JAX package's ``lax.scan`` body -- writes each recorded
    round's metrics into a device buffer, and reads the executed budgets and
    the metric rows back once at the end; the ``SystemsTrace`` then replays
    the executed budgets.

The two give the same bits on a fixed seed: the scanned round runs every
chunk of the local solve, the loop's round stops after the last live one,
and dead chunks add exact zeros.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.engine import RoundEngine, get_engine
from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.regularizers import Regularizer, sigma_prime
from repro_torch.core.subproblem import resolve_gram
from repro_torch.core.systems_model import SystemsConfig, SystemsTrace
from repro_torch.core.theta import (BudgetConfig, presample_budgets,
                                    round_budgets, round_key_schedule,
                                    validate_assumption2)
from repro_torch.obs import NULL_TELEMETRY, Telemetry
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import tick

Tensor = torch.Tensor

#: every run records exactly these history columns, each on the
#: ``record_every`` cadence
HISTORY_KEYS = ("round", "dual", "primal", "gap", "time", "round_max_steps")

DRIVERS = ("auto", "scan", "loop")

#: held while a ``RoundProgram`` is captured as a CUDA graph; a thread that
#: works on the card beside the capturing one (the cohort pack worker) holds
#: it around that work, so no other thread's allocation or copy falls
#: inside a capture
CAPTURE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class MochaConfig:
    loss: str = "hinge"
    rounds: int = 100                  # total federated W rounds
    omega_update_every: int = 0        # 0 = fixed Omega; k = every k rounds
    gamma: float = 1.0                 # aggregation parameter (Remark 3)
    per_task_sigma: bool = True        # Remark 5 per-task sigma'_t
    budget: BudgetConfig = dataclasses.field(default_factory=BudgetConfig)
    engine: str = "local"              # local | kernel | sharded
    network: str = "lte"
    systems: Optional[SystemsConfig] = None  # full systems model
    seed: int = 0
    record_every: int = 1
    driver: str = "auto"               # auto | scan | loop
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
    #: host seconds the scanned driver spent on the round's CUDA graph
    #: (warm-up round, capture, instantiation); None where none was captured
    capture_s: Optional[float] = None

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


@dataclasses.dataclass
class _Run:
    """What both drivers start from: the data on the run's device, the
    engine bound to it, the first dual state, Omega and its coupling
    terms."""

    data: FederatedData
    reg: Regularizer
    cfg: MochaConfig
    loss: Loss
    eng: RoundEngine
    trace: SystemsTrace
    state: DualState
    omega: Tensor
    abar: Tensor
    K: Tensor
    q_t: Tensor
    max_steps: int
    gram: Optional[bool]

    def omega_step(self, v: Tensor):
        """Algorithm 1's Omega update from W(v).  Omega changed, so the
        dual problem did: v = X alpha stays, W(alpha) and the objectives
        take the new K.  Returns the new (K, q_t)."""
        W = dual_mod.primal_weights(self.K, v)
        self.omega = self.reg.update_omega(W, self.omega)
        self.abar, self.K, self.q_t = _coupling_terms(
            self.reg, self.omega, self.cfg.gamma, self.cfg.per_task_sigma,
            self.data.m)
        return self.K, self.q_t


def _start(data: FederatedData, reg: Regularizer, cfg: MochaConfig,
           omega0=None, engine=None, trace: Optional[SystemsTrace] = None,
           state0: Optional[DualState] = None) -> _Run:
    """Check the configuration and set a run up (see ``_run_mocha``)."""
    loss = get_loss(cfg.loss)
    validate_assumption2(cfg.budget)
    if cfg.driver not in DRIVERS:
        raise ValueError(f"driver {cfg.driver!r} not in {DRIVERS}")
    dev = resolve_device(cfg.device)
    eng = get_engine(engine if engine is not None else cfg.engine)
    if cfg.driver == "scan" and not eng.supports_scan:
        raise ValueError(
            f"engine {eng.name!r} does not support the scanned driver; "
            "use driver='auto' or 'loop'")
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
    return _Run(data, reg, cfg, loss, eng, trace, state, omega, abar, K, q_t,
                max_steps, gram)


def _run_mocha(data: FederatedData, reg: Regularizer, cfg: MochaConfig,
               omega0=None,
               budget_fn: Optional[Callable[[Tensor, Tensor, int],
                                            Tensor]] = None,
               engine=None,
               trace: Optional[SystemsTrace] = None,
               state0: Optional[DualState] = None,
               telemetry: Optional[Telemetry] = None,
               programs: Optional[Dict[tuple, "RoundProgram"]] = None,
               ) -> RunResult:
    """Run Algorithm 1 on the configured round engine.

    ``budget_fn(key, n_t, round) -> (m,) int budgets`` overrides the
    BudgetConfig sampler; ``engine`` overrides ``cfg.engine`` (a name,
    class or instance); ``trace`` continues a SystemsTrace; ``omega0`` and
    ``state0`` (alpha, v with v = X alpha) warm-start the run.  The data
    and the warm starts move to ``cfg.device``.

    ``telemetry`` (a ``repro_torch.obs.Telemetry``) gets the JAX package's
    spans: ``mocha.run`` around the run, and on the pre-sampled driver
    ``mocha.presample``, one ``mocha.scan_dispatch`` per Omega segment and
    ``mocha.host_pull``.  Spans read the host clock only, so results are
    the same bits with telemetry on, off or absent.

    ``programs`` is a cache of round programs that outlives the run, keyed
    by what fixes a program's shapes (``_program_key``): a run whose key is
    in it copies its data, warm start and first round's inputs into that
    program instead of building (on the card: capturing) a new one.  The
    cohort block loop passes one cache for all of its blocks, so a run of
    blocks captures once.  The result's ``state`` is then a copy, since the
    program's buffers serve the next run.
    """
    run = _start(data, reg, cfg, omega0, engine, trace, state0)
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    if tel.enabled:
        # a pure read of the simulated clock; binding the same shared trace
        # again (the cohort case) changes nothing
        trace = run.trace
        tel.set_sim_clock(lambda: trace.elapsed_s)
    scanned = cfg.driver != "loop" and run.eng.supports_scan
    with tel.span("mocha.run", rounds=cfg.rounds, engine=run.eng.name,
                  driver="scan" if scanned else "loop"):
        if scanned:
            return _run_scanned(run, budget_fn, tel, programs)
        return _run_loop(run, budget_fn)


def _run_loop(run: _Run, budget_fn) -> RunResult:
    """The round loop: one engine call and one host read per round."""
    cfg, data, trace, state = run.cfg, run.data, run.trace, run.state
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
        budgets = torch.clamp_max(budgets, run.max_steps)
        cap = trace.begin_round()
        if cap is not None:   # semi_sync: fit the work to the clock cycle
            cap = np.minimum(cap, run.max_steps)
            budgets = torch.minimum(budgets, torch.as_tensor(
                cap, dtype=budgets.dtype, device=budgets.device))
        state = run.eng.round(state, run.K, run.q_t, budgets, cfg.gamma,
                              k_round)
        steps_np = budgets.cpu().numpy()
        trace.commit(steps_np)
        budgets_log.append(steps_np.astype(np.int64))

        if cfg.omega_update_every and (h + 1) % cfg.omega_update_every == 0:
            run.omega_step(state.v)

        if record[h]:
            dual_val, primal_val, gap = _metrics(run.loss, data, state,
                                                 run.abar, run.K)
            history["round"].append(h)
            history["dual"].append(float(dual_val))
            history["primal"].append(float(primal_val))
            history["gap"].append(float(gap))
            history["time"].append(trace.elapsed_s)
            history["round_max_steps"].append(int(steps_np.max()))

    W = dual_mod.primal_weights(run.K, state.v)
    return RunResult(W=W.cpu().numpy(), omega=run.omega.cpu().numpy(),
                     state=state, history=history, trace=trace,
                     round_budgets=np.stack(budgets_log))


class RoundProgram:
    """One round over static buffers, run once per round.

    ``step(state, inputs) -> state`` is a round of tensors that reads
    nothing back to the host.  The program holds its own copy of the state
    (a tuple of tensors) and of every named input; ``run(**inputs)`` copies
    new values into those input buffers (``copy_``: a buffer is never
    rebound, so a captured graph reads the new values) and runs the round,
    which writes the new state into the state buffers.  ``reset(state)``
    copies a new state in, so one program serves runs of the same shapes.

    On a CUDA device the round is captured once as a ``torch.cuda.CUDAGraph``
    and ``run`` replays it.  A warm-up round runs first on a side stream and
    its effect on the state is undone; a capture that fails raises.  The
    capture holds ``CAPTURE_LOCK``.  On the CPU the round runs eagerly.
    ``capture_s`` is the host time of warm-up, capture and instantiation
    (None on the CPU); ``RoundProgram.captures`` counts the captures made
    in the process.
    """

    #: CUDA graph captures since the process started (or a test reset it)
    captures = 0

    def __init__(self, step: Callable, state: Sequence[Tensor],
                 inputs: Dict[str, Tensor]):
        self.step = step
        self.state = tuple(t.clone() for t in state)
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s: Optional[float] = None
        if self.state[0].device.type == "cuda":
            with CAPTURE_LOCK:
                self._capture(self.state[0].device)

    def _round(self) -> None:
        for buf, new in zip(self.state, self.step(self.state, self.inputs)):
            buf.copy_(new)

    def _capture(self, dev: torch.device) -> None:
        t0 = tick()
        before = tuple(t.clone() for t in self.state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._round()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.reset(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._round()
        self.graph = graph
        self.capture_s = tick() - t0
        RoundProgram.captures += 1

    def reset(self, state: Sequence[Tensor]) -> None:
        """Copy a new state into the state buffers."""
        for buf, new in zip(self.state, state):
            buf.copy_(new)

    def set(self, **inputs: Tensor) -> None:
        """Copy new values into the named input buffers."""
        for name, value in inputs.items():
            self.inputs[name].copy_(value)

    def run(self, **inputs: Tensor) -> None:
        """``set(**inputs)``, then one round."""
        self.set(**inputs)
        if self.graph is None:
            self._round()
        else:
            self.graph.replay()


def presample_round_inputs(cfg: MochaConfig, key: Tensor, n_t: Tensor,
                           max_steps: int, caps: Optional[np.ndarray],
                           budget_fn=None):
    """The whole run's (rounds, 2) round keys and (rounds, m) budgets, as
    the loop driver would draw them round by round: budgets clamped to
    ``max_steps``, then to the semi_sync caps (clamped to ``max_steps`` on
    the host before the cast, as the loop does)."""
    budget_keys, round_keys = round_key_schedule(key, cfg.rounds)
    if budget_fn is not None:
        budgets = torch.stack([budget_fn(budget_keys[h], n_t, h)
                               for h in range(cfg.rounds)])
    else:
        budgets = presample_budgets(cfg.budget, budget_keys, n_t)
    budgets = torch.clamp_max(budgets, max_steps)
    if caps is not None:
        caps = np.minimum(caps, max_steps)
        budgets = torch.minimum(budgets, torch.as_tensor(
            caps, dtype=budgets.dtype, device=budgets.device))
    return round_keys, budgets


def _data_inputs(data: FederatedData) -> Dict[str, Tensor]:
    """A federation's tensors as round-program inputs (``xnorm2`` filled)."""
    return dict(X=data.X, y=data.y, mask=data.mask, xnorm2=data.xnorm2)


def _round_program(round_fn: Callable, loss: Loss, max_steps: int,
                   gram: Optional[bool], data: FederatedData,
                   state: DualState, gamma: float, key: Tensor,
                   budgets: Tensor, K: Tensor, q_t: Tensor) -> RoundProgram:
    """A ``RoundProgram`` of ``round_fn`` (an engine's ``scan_round_fn``)
    from ``state``, its inputs set to ``data`` (which needs its ``xnorm2``)
    and the first round's key, budgets, K and q_t.  The data is an input,
    so the program serves any federation of the same shapes."""
    def step(st, x):
        fed = FederatedData(X=x["X"], y=x["y"], mask=x["mask"],
                            xnorm2=x["xnorm2"])
        return round_fn(loss, max_steps, gram, fed, DualState(*st), x["K"],
                        x["q_t"], x["budgets"], gamma, x["key"])

    return RoundProgram(step, state, dict(key=key, budgets=budgets, K=K,
                                          q_t=q_t, **_data_inputs(data)))


def _segments(rounds: int, every: int):
    """[h0, h_end) spans of rounds between Omega steps (Omega after each
    ``every``-th round; one segment when ``every`` is 0)."""
    h0 = 0
    while h0 < rounds:
        h_end = min(rounds, (h0 // every + 1) * every) if every else rounds
        yield h0, h_end
        h0 = h_end


def _replay_rounds(prog: RoundProgram, round_keys: Tensor,
                   budgets: Tensor, every: int,
                   omega_step: Optional[Callable] = None,
                   after_round: Optional[Callable[[int], None]] = None,
                   tel: Telemetry = NULL_TELEMETRY,
                   built: bool = False) -> None:
    """Run ``prog`` once per row of the pre-sampled inputs.  After every
    ``every``-th round ``omega_step(v)`` ends a segment: it runs eagerly
    between two runs (its host reads are legal there) and returns the new
    K and q_t, which are copied into the program's buffers.  Then
    ``after_round(h)``.  Each segment is one ``mocha.scan_dispatch`` span:
    on the card it times the host's enqueue of the segment's replays, not
    their execution (that surfaces in ``mocha.host_pull``); ``compile``
    tags the first segment of a run that built ``prog`` (``built``)."""
    for h0, h_end in _segments(len(round_keys), every):
        with tel.span("mocha.scan_dispatch", h0=h0, h_end=h_end,
                      compile=built and h0 == 0):
            for h in range(h0, h_end):
                prog.run(key=round_keys[h], budgets=budgets[h])
                if every and (h + 1) % every == 0:
                    K, q_t = omega_step(prog.state[1])
                    prog.set(K=K, q_t=q_t)
                if after_round is not None:
                    after_round(h)


def _program_key(run: _Run) -> tuple:
    """What fixes a round program: the engine's round function, the loss,
    the federation's shapes and device, ``max_steps``, the residual mode
    and gamma (the cohort's engine, loss, K, n_pad, d, max_steps, gram,
    gamma)."""
    return (run.eng.scan_round_fn(), run.loss.name, tuple(run.data.X.shape),
            str(run.data.device), run.max_steps, run.gram, run.cfg.gamma)


def _scanned_program(run: _Run, budget_fn=None,
                     programs: Optional[Dict[tuple, RoundProgram]] = None,
                     tel: Telemetry = NULL_TELEMETRY):
    """The pre-sampled driver's inputs and program: the run's (rounds, 2)
    round keys and (rounds, m) budgets (span ``mocha.presample``), and the
    ``RoundProgram`` of the engine's round function set to them: a cached
    one from ``programs`` when its key is there, else a new one (added to
    ``programs``).  Returns (keys, budgets, program, built)."""
    cfg = run.cfg
    with tel.span("mocha.presample", rounds=cfg.rounds):
        round_keys, budgets = presample_round_inputs(
            cfg, prng.PRNGKey(cfg.seed, device=run.data.device),
            run.data.n_t, run.max_steps, run.trace.presample_caps(cfg.rounds),
            budget_fn)
    key = _program_key(run) if programs is not None else None
    prog = None if key is None else programs.get(key)
    if prog is not None:
        prog.set(key=round_keys[0], budgets=budgets[0], K=run.K,
                 q_t=run.q_t, **_data_inputs(run.data))
        prog.reset(run.state)
        return round_keys, budgets, prog, False
    prog = _round_program(run.eng.scan_round_fn(), run.loss, run.max_steps,
                          run.gram, run.data, run.state, cfg.gamma,
                          round_keys[0], budgets[0], run.K, run.q_t)
    if key is not None:
        programs[key] = prog
    return round_keys, budgets, prog, True


def _run_scanned(run: _Run, budget_fn, tel: Telemetry = NULL_TELEMETRY,
                 programs: Optional[Dict[tuple, RoundProgram]] = None
                 ) -> RunResult:
    """The pre-sampled driver: every round through one ``RoundProgram``.

    A recorded round's metrics go into a device buffer; an Omega round's
    are taken after the refresh, as the loop takes them.
    """
    cfg, trace = run.cfg, run.trace
    rounds = cfg.rounds
    round_keys, budgets, prog, built = _scanned_program(run, budget_fn,
                                                        programs, tel)
    record = _record_rounds(rounds, cfg.record_every)
    rows = torch.zeros((rounds, 3), dtype=run.K.dtype, device=run.K.device)

    def write_row(h):
        if record[h]:
            rows[h] = torch.stack(_metrics(run.loss, run.data,
                                           DualState(*prog.state), run.abar,
                                           run.K))

    _replay_rounds(prog, round_keys, budgets, cfg.omega_update_every,
                   run.omega_step, write_row, tel, built)

    # the one host transfer: executed budgets and the metric rows
    with tel.span("mocha.host_pull", rounds=rounds):
        executed = budgets.cpu().numpy().astype(np.int64)
        rows_np = rows.cpu().numpy()
        trace.replay(executed)
    times = trace.times()[-rounds:]
    history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
    for h in np.flatnonzero(record):
        history["round"].append(int(h))
        history["dual"].append(float(rows_np[h, 0]))
        history["primal"].append(float(rows_np[h, 1]))
        history["gap"].append(float(rows_np[h, 2]))
        history["time"].append(float(times[h]))
        history["round_max_steps"].append(int(executed[h].max()))
    state = DualState(*prog.state)
    if programs is not None:   # the program's buffers serve the next run
        state = DualState(*(t.clone() for t in state))
    W = dual_mod.primal_weights(run.K, state.v)
    return RunResult(W=W.cpu().numpy(), omega=run.omega.cpu().numpy(),
                     state=state, history=history, trace=trace,
                     round_budgets=executed,
                     capture_s=prog.capture_s if built else None)


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
