"""Cross-device MOCHA over a streaming population: the cohort block loop.

The port's copy of the JAX package's ``repro.cohort.driver``, entered
through ``repro_torch.api.Experiment(problem=Problem(population=...))``
(the deprecated ``run_mocha_cohort`` shim is not ported).

One outer round (a *block*) is: sample a cohort of K clients from the
population, pack it as an m=K federation, and run ``run_mocha`` on it --
the SAME driver, engines, budget controller, and systems clock as the
cross-silo path -- warm-started from the factored global state and with the
cohort's expanded K x K relationship block as its (fixed) Omega.  The
solved block is folded back into the O(m + k^2) ``ClusterOmega`` state and
the next block is sampled.

What stays device-resident / bounded:

  * the inner W-round loop runs on the pre-sampled driver whenever the
    engine supports it (selection, drops, and budgets are all pre-sampled),
    through ONE round program reused across blocks: shapes are static by
    construction (K and ``n_pad`` never change), so the solve stage keeps
    a cache of programs keyed by their shapes (``mocha._program_key``) and
    each block copies its data and warm start into the cached one.  On the
    card that is one CUDA graph captured per run, not one per block (the
    JAX package's jit compiles its ``lax.scan`` once for the same reason);
    the kernel engine keeps the loop driver, one SDCA launch per inner
    round;
  * population state never materializes: O(K * n_pad * d) cohort tensors,
    O(m) assignment/availability vectors, O(k^2 + k d) relationship state,
    a bounded client cache.  No O(m^2) object exists anywhere
    (the tests pin the memory budget).

Two block loops share the machinery above (``_BlockLoop``):

  * the SEQUENTIAL loop (``overlap = 1``, ``staleness = 0``): pack, solve,
    fold, one block at a time -- the reference semantics;
  * the PIPELINED loop (``overlap > 1`` or ``staleness > 0``): a software
    pipeline of three single-worker stages.  A pack worker prefetches up
    to ``overlap`` blocks ahead; a solve worker runs the device programs
    strictly serially (so the shared ``SystemsTrace`` advances in block
    order at ANY staleness); the main thread samples, snapshots launch
    state, and folds completed blocks while the solve worker is busy.  The
    ``StalenessBoundedMerger`` (repro_torch.cohort.omega) bounds how many
    solved-but-unmerged blocks a launch may run ahead of: at
    ``staleness = 0`` every prior block folds before each launch and the
    pipeline is BIT-IDENTICAL to the sequential loop (the parity
    contract); at S >= 1 launches read state at most
    S blocks behind -- a bounded-inexactness source in the spirit of the
    paper's inexact local solves.  Merge points depend only on block
    COUNTS, never on thread timing, so results are deterministic at every
    (overlap, staleness).

With K = m, a uniform sampler, no dropout, and omega refreshes off, every
block is exactly one full-participation MOCHA round over the (permuted)
population with the equivalent fixed Omega -- the cohort driver degrades to
plain ``_run_mocha``.

Only the pack and solve stages touch the card.  The main thread's launch
and fold work on host state (numpy), and the expanded Omega and warm start
travel to the solve stage as host arrays.  The pack stage's device work and
a round program's capture exclude each other (``mocha.CAPTURE_LOCK``), so a
capture on the solve thread never sees another thread's allocation or
copy.  Both stages pass the run's device explicitly.

Both loops are FAULT-TOLERANT through ``repro_torch.cohort.resilience``: the
pack and solve stages run behind retry-with-backoff wrappers
(``pack_block`` / ``solve_block``) that inject the pre-sampled
``FaultPlan`` faults at the real seams, degrade exhausted blocks to
dropped-node folds, and periodically checkpoint the whole mutable state
for bit-identical resume.  All of it is inert by default: with no faults,
no retries, and no checkpointing configured, the wrappers reduce to the
bare pack/solve calls and results are bit-identical to the
pre-resilience driver.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cohort.omega import ClusterOmega, StalenessBoundedMerger
from repro_torch.cohort.packing import CohortPacker
from repro_torch.cohort.population import Population
from repro_torch.cohort.resilience import (BlockFailure, CohortCheckpointer,
                                           FaultConfig, FaultPlan,
                                           FaultStats, InjectedFault,
                                           backoff_delay, run_fingerprint)
from repro_torch.cohort.sampler import CohortSampler, CohortSchedule
from repro_torch.core import dual as dual_mod
from repro_torch.core.dual import DualState
from repro_torch.core.mocha import (HISTORY_KEYS, MochaConfig, RoundProgram,
                                    _record_rounds, _run_mocha)
from repro_torch.core.regularizers import Regularizer
from repro_torch.core.systems_model import (SystemsConfig, SystemsTrace,
                                            population_rates)
from repro_torch.core.theta import drop_masked_budgets
from repro_torch.utils.device import resolve_device

#: domain-separation tag for per-block inner-driver seeds
_BLOCK_STREAM = 0x626C6B   # "blk"

#: the cohort history = the driver history + cross-device coverage
COHORT_HISTORY_KEYS = HISTORY_KEYS + ("unique_clients",)


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Cross-device run description: outer-loop knobs + an INNER MochaConfig.

    The inner per-block solver settings (loss, budgets, gamma, engine, gram
    crossover, device, ...) are a plain ``MochaConfig`` view under
    ``inner``; ``repro_torch.api.as_cohort_config`` builds both layers from
    one set of sub-specs.  ``inner.rounds`` / ``inner.record_every`` /
    ``inner.omega_update_every`` / ``inner.seed`` are owned by the block
    loop (``inner_config`` overrides them), everything else passes through.
    """

    rounds: int = 100                  # cohort blocks (outer rounds)
    cohort: int = 64                   # K sampled clients per block
    inner_rounds: int = 1              # W-rounds run on each cohort
    sampler: str = "uniform"           # uniform | weighted (availability)
    dropout: float = 0.0               # selected-but-failed probability
    clusters: int = 3                  # k of the factored relationship
    eta: float = 0.5                   # per-client self-affinity in Omega_S
    omega_update_every: int = 0        # blocks between cluster-Omega steps
    cache_clients: int = 4096          # bounded warm-start/delta cache
    network: str = "lte"
    systems: Optional[SystemsConfig] = None
    seed: int = 0
    record_every: int = 1
    n_pad: Optional[int] = None        # None = PopulationSpec.pad_width
    overlap: int = 1                   # pack-prefetch depth (1 = sequential)
    staleness: int = 0                 # max solved-but-unmerged at launch
    # -- resilience (repro_torch.cohort.resilience); all inert by default, so the
    # -- zero-fault path is bit-identical to the pre-resilience driver
    max_retries: int = 0               # per-block retry budget (pack + solve)
    degrade: bool = False              # exhausted block -> dropped-node fold
    faults: Optional[FaultConfig] = None  # deterministic fault injection
    checkpoint_every: int = 0          # blocks between snapshots (0 = off)
    checkpoint_dir: Optional[str] = None  # where step_<block>.ckpt land
    resume: bool = False               # restore latest snapshot, continue
    # -- telemetry (repro_torch.obs); READS state only, so the off path (the
    # -- default) is bit-identical to the instrumented-but-disabled run
    telemetry: bool = False            # record spans + metrics for this run
    trace_dir: Optional[str] = None    # Chrome trace JSON output directory
    #: the per-block solver view; engine shards the COHORT, never the
    #: population
    inner: MochaConfig = dataclasses.field(default_factory=MochaConfig)

    def inner_config(self) -> MochaConfig:
        """The effective per-block driver config (seed set per block)."""
        return dataclasses.replace(
            self.inner, rounds=self.inner_rounds, omega_update_every=0,
            record_every=self.inner_rounds)


@dataclasses.dataclass
class CohortRunResult:
    """Factored final state + per-block history (no O(m^2), no O(m*d))."""

    relationship: ClusterOmega
    history: Dict[str, List[float]]
    trace: SystemsTrace
    schedule: CohortSchedule
    rate_mult: np.ndarray          # (m,) per-client hardware multipliers
    #: (m,) blocks in which each client EXECUTED steps (the ground truth the
    #: state updates used; ``schedule.participation_counts`` is only the
    #: schedule-level upper bound -- budget drops happen below it).  Always
    #: populated by ``_run_cohort``; Optional only so the dataclass field
    #: has a well-typed empty default.
    participation: Optional[np.ndarray] = None
    #: fault accounting (retries charged, blocks degraded); stamped into
    #: Report provenance.  Always populated by
    #: ``_run_cohort``.
    fault_stats: Optional[FaultStats] = None
    #: the checkpointed block this run resumed after (None = fresh run)
    resumed_from: Optional[int] = None
    #: round programs this run captured as CUDA graphs (0 on the CPU and on
    #: the kernel engine; 1 on the card's pre-sampled driver, whatever the
    #: number of blocks) and their host seconds (None where none was)
    captures: int = 0
    capture_s: Optional[float] = None

    @property
    def omega_k(self) -> np.ndarray:
        return self.relationship.omega_k

    @property
    def centroids(self) -> np.ndarray:
        return self.relationship.centroids

    @property
    def assign(self) -> np.ndarray:
        return self.relationship.assign

    def client_weights(self, ids) -> np.ndarray:
        """Serving weights for ANY client ids (cohort-sized, on demand)."""
        return self.relationship.client_weights(np.asarray(ids))

    def final(self, key: str) -> float:
        return self.history[key][-1]


def _block_seed(seed: int, block: int) -> int:
    """Deterministic per-block inner-driver seed (domain-separated)."""
    ss = np.random.SeedSequence([_BLOCK_STREAM, seed, block])
    return int(ss.generate_state(1, np.uint32)[0])


@dataclasses.dataclass
class _SolvedBlock:
    """Host-side snapshot of one solved block.

    Every field is plain host data, pulled off-device by the SOLVE stage:
    the fold stage touches no device buffers, so folding block b - 1 on the
    main thread never synchronizes with block b's running program.
    ``elapsed_s`` is the trace clock captured right after this block's
    rounds committed -- at any staleness the solve worker advances the
    trace strictly in block order, so this is the same value the sequential
    loop records.
    """

    W: np.ndarray            # (K, d) solved cohort weights
    alpha: np.ndarray        # (K, n_pad) solved dual blocks
    participated: np.ndarray  # (K,) bool: slot executed > 0 steps
    max_steps: int           # max over the executed budget matrix
    dual: float
    primal: float
    gap: float
    elapsed_s: float
    # -- resilience bookkeeping, filled by the solve-stage wrapper ----------
    degraded: bool = False   # exhausted retries, folded as dropped-node
    retries: int = 0         # failed solve attempts that were retried
    pack_retries: int = 0    # failed pack attempts (carried from pack stage)
    #: ``SystemsTrace.clock_state`` captured after this block's rounds
    #: committed; only populated when checkpointing is active (the fold
    #: stage keeps the latest one as the frontier clock for snapshots)
    clock: Optional[dict] = None
    #: host seconds of the CUDA graph this block's solve captured (the
    #: run's first solve on the card); None where it captured none
    capture_s: Optional[float] = None


@dataclasses.dataclass
class _PackedBlock:
    """Pack-stage hand-off: the packed federation plus fault bookkeeping.

    ``penalty_s`` is retry backoff accrued in the PACK stage; the pack
    worker must not touch the solve-owned ``SystemsTrace``, so the charge
    travels with the payload and the solve stage applies it first.
    ``data is None`` marks a pack-exhausted block under degradation (the
    solve stage folds it as dropped-node without packing anything).
    """

    data: Optional[object]   # FederatedData, or None = degraded at pack
    sizes: np.ndarray        # (K,) int64 true client sizes
    penalty_s: float = 0.0   # backoff to charge to the simulated clock
    retries: int = 0         # failed pack attempts


class _BlockLoop:
    """Per-block machinery shared by the sequential and pipelined drivers.

    The three stages are thread-role-separated: ``launch_args`` and
    ``fold`` touch the mutable ``ClusterOmega`` and run on the MAIN thread
    only; ``solve`` owns the shared ``SystemsTrace`` and runs on a single
    solve worker (or inline, sequentially) so the simulated clock advances
    in block order no matter how deep the pipeline is.

    The split is a checked contract: mutable attributes carry an
    ``# owner: pack|solve|main`` annotation and every stage method a
    ``# worker:`` tag, as in the JAX package (whose ``tools/reprolint``
    rules T301/T302 reject any access that crosses the ownership line).
    Unannotated attributes are launch-time constants (read-only after
    ``__init__``, safe from any thread).
    """

    def __init__(self, pop: Population, reg: Regularizer, cfg: CohortConfig,
                 telemetry: Optional[obs.Telemetry] = None):
        m, spec = pop.m, pop.spec
        self.cfg, self.reg = cfg, reg
        self.n_pad = int(cfg.n_pad or spec.pad_width)
        self.d = spec.d
        #: the run's device, passed explicitly to every stage (torch's
        #: current device and stream are per thread)
        self.device = resolve_device(cfg.inner.device)
        # telemetry: launch-time constants (readable from any thread); the
        # per-worker VIEWS route each stage's spans to its own lock-free
        # buffer, so the instruments below never share a writing thread
        self.tel = (telemetry if telemetry is not None
                    else obs.telemetry(cfg.telemetry))
        self.tel_pack = self.tel.for_worker("pack")
        self.tel_solve = self.tel.for_worker("solve")
        self.state = ClusterOmega(m, cfg.clusters, spec.d, reg, eta=cfg.eta,
                                  cache_clients=cfg.cache_clients,
                                  metrics=(self.tel.metrics if self.tel.enabled
                                           else None),
                                  device=self.device)  # owner: main
        self.merger = StalenessBoundedMerger(
            self.state, reg, omega_update_every=cfg.omega_update_every,
            staleness=cfg.staleness)  # owner: main

        # population hardware: one O(m) multiplier vector drives BOTH the
        # availability-weighted sampler and the per-block clock injection
        sys_cfg = cfg.systems or SystemsConfig(network=cfg.network)
        self.rate_mult = population_rates(m, sys_cfg)
        sampler = CohortSampler(
            m=m, cohort=cfg.cohort, kind=cfg.sampler, dropout=cfg.dropout,
            weights=self.rate_mult if cfg.sampler == "weighted" else None)
        self.schedule = sampler.presample(cfg.seed, cfg.rounds)

        # cohort-slot trace: slot s hosts a different client each block, so
        # the static per-slot rate draw is neutralized (rate_lo = rate_hi =
        # 1) and the sampled clients' multipliers are injected per block
        slot_cfg = dataclasses.replace(sys_cfg, rate_lo=1.0, rate_hi=1.0)
        self.trace = SystemsTrace(cfg.cohort, spec.d, slot_cfg)  # owner: solve
        # the simulated-clock column on every span: a pure READ of the
        # trace clock (closure over the local, not self -- no cross-owner
        # attribute access from worker threads)
        trace = self.trace
        self.tel.set_sim_clock(lambda: trace.elapsed_s)

        self.inner = cfg.inner_config()
        self.packer = CohortPacker(pop, cfg.cohort, self.n_pad,
                                   self.device)  # owner: pack
        #: round programs of the pre-sampled driver, keyed by their shapes:
        #: every block of the run replays the one built by the first
        self._programs: Dict[tuple, RoundProgram] = {}  # owner: solve

        self.record = _record_rounds(cfg.rounds, cfg.record_every)
        self.history: Dict[str, List[float]] = {
            k: [] for k in COHORT_HISTORY_KEYS}  # owner: main
        self.seen = np.zeros(m, bool)  # owner: main
        self.n_seen = 0  # owner: main
        self.participation = np.zeros(m, np.int64)  # owner: main
        #: host seconds of each CUDA graph captured, as the solved blocks
        #: hand them over
        self.graph_captures: List[float] = []  # owner: main

        # -- resilience: fault plan, retry budget, checkpoint/resume --------
        if cfg.max_retries < 0:
            raise ValueError(f"need max_retries >= 0, got {cfg.max_retries}")
        self.max_attempts = cfg.max_retries + 1
        self.plan: Optional[FaultPlan] = None
        if cfg.faults is not None:
            self.plan = FaultPlan.presample(cfg.faults, cfg.seed, cfg.rounds,
                                            cfg.max_retries)
            if cfg.degrade:
                # the plan is total, so the Assumption-2 guard fires BEFORE
                # any block runs (clear diagnostic instead of a useless run)
                self.plan.validate_assumption2(cfg.dropout)
        self.stats = FaultStats()  # owner: main
        #: (dual, primal, gap) of the last non-degraded fold: a degraded
        #: block records carried-forward metrics (its own are undefined --
        #: nothing was solved), keeping the history NaN-free and resumable
        self._last_metrics = (0.0, 0.0, 0.0)  # owner: main
        self._last_clock: Optional[dict] = None  # owner: main
        #: post-fold hook, called on the fold thread AFTER block b merges
        #: (so it may read main-owned state); wired at launch time, before
        #: any block runs.  The serve tier's snapshot publisher lives here.
        self.on_fold: Optional[Callable[[int], None]] = None  # owner: main
        #: launch-time (alpha0, omega0) of launched-but-unfolded blocks;
        #: checkpointed so staleness >= 1 resumes replay the EXACT staler
        #: state those launches read (dict empty unless checkpointing)
        self._launch_snaps: Dict[int, tuple] = {}  # owner: main
        self._resume_snaps: Dict[int, tuple] = {}  # owner: main
        self.start_block = 0
        self.resumed_from: Optional[int] = None
        self._ckpt: Optional[CohortCheckpointer] = None
        if (cfg.checkpoint_every > 0 or cfg.resume
                or cfg.checkpoint_dir is not None):
            if cfg.checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every/resume need CohortConfig."
                    "checkpoint_dir")
            self._ckpt = CohortCheckpointer(
                cfg.checkpoint_dir, cfg.checkpoint_every,
                run_fingerprint(pop, reg, cfg), telemetry=self.tel)
        if cfg.resume:
            # workers are not running yet: restore writes every owned field
            # from the latest snapshot, then the loops start at the frontier
            self.start_block = self._ckpt.restore_into(self)
            self.resumed_from = self.start_block - 1

    def launch_args(self, b: int):  # worker: main
        """MAIN THREAD: block b's cohort + its launch-time state snapshot.

        The warm-start alpha rows and the expanded cohort Omega are read
        from the mutable ``ClusterOmega`` here, at launch -- this read
        point is exactly what the staleness bound governs.  On a resumed
        run, a block that had already launched before the interruption
        reads its CHECKPOINTED launch snapshot instead: at staleness >= 1
        that launch observed state staler than the restored frontier, so
        recomputing it here would break resume bit-identity.
        """
        ids, dropped = self.schedule.ids[b], self.schedule.dropped[b]
        # merge-frontier staleness this launch observes (0 = fully fresh)
        self.tel.histogram("launch_staleness").observe(
            b - 1 - self.merger.merged_through)
        snap = self._resume_snaps.pop(b, None)
        if snap is not None:
            alpha0, omega0 = snap
        else:
            alpha0 = self.state.cohort_alpha(ids, self.n_pad)
            omega0 = self.state.cohort_block(ids)
        if self._ckpt is not None:
            self._launch_snaps[b] = (alpha0, omega0)
        # host arrays: the solve stage moves them to the device
        return ids, dropped, alpha0, omega0

    def solve(self, b: int, data, ids, dropped, alpha0_np,
              omega0) -> _SolvedBlock:  # worker: solve
        """SOLVE STAGE: block b's device program + host pulls.

        Strictly serial across blocks (inline or on the one-worker solve
        pool), so ``set_rate_scale`` / trace draws / commits interleave in
        block order at any pipeline depth.  The pre-sampled driver replays
        the run's one cached round program (``self._programs``).
        """
        cfg, inner = self.cfg, self.inner
        self.trace.set_rate_scale(self.rate_mult[ids])
        alpha0 = torch.from_numpy(alpha0_np).to(data.device)
        warm = DualState(alpha=alpha0, v=dual_mod.compute_v(data, alpha0))
        res = _run_mocha(
            data, self.reg,
            dataclasses.replace(inner, seed=_block_seed(cfg.seed, b)),
            omega0=omega0,
            budget_fn=drop_masked_budgets(
                inner.budget, np.broadcast_to(
                    dropped, (cfg.inner_rounds, cfg.cohort)).copy()),
            trace=self.trace, state0=warm, telemetry=self.tel_solve,
            programs=self._programs)
        budgets = np.asarray(res.round_budgets)
        return _SolvedBlock(
            W=np.asarray(res.W), alpha=res.state.alpha.cpu().numpy(),
            participated=budgets.sum(axis=0) > 0,
            # max over the block's EXECUTED budget matrix, not the inner
            # history column (which subsamples to record rounds only)
            max_steps=int(budgets.max()),
            dual=res.final("dual"), primal=res.final("primal"),
            gap=res.final("gap"), elapsed_s=self.trace.elapsed_s,
            capture_s=res.capture_s)

    def pack_block(self, b: int) -> _PackedBlock:  # worker: pack
        """PACK STAGE wrapper: fault injection + retry for block b.

        ``CohortPacker.pack`` is retry-idempotent (its staging buffers are
        fully overwritten per call), so a failed attempt -- injected or
        real -- is simply re-run.  Backoff cannot be charged here (the
        simulated clock is solve-owned), so it accrues as ``penalty_s`` in
        the payload.  An exhausted block either raises ``BlockFailure`` or,
        under degradation, hands the solve stage a ``data=None`` marker.
        """
        ids = self.schedule.ids[b]
        penalty, fails, err = 0.0, 0, None
        with self.tel_pack.span("pack", block=b) as sp:
            for a in range(self.max_attempts):
                if self.plan is not None and self.plan.pack_fails(b, a):
                    err = InjectedFault("pack", b, a)
                else:
                    try:
                        data, sizes = self.packer.pack(ids)
                        sp.set(attempts=a + 1)
                        self.tel_pack.counter("blocks_packed").inc()
                        return _PackedBlock(data, sizes, penalty, fails)
                    except Exception as e:  # noqa: BLE001 -- retried, then
                        err = e  # raised/degraded below (never dropped)
                fails += 1
                backoff = (self.plan.backoff(a) if self.plan is not None
                           else backoff_delay(a))
                penalty += backoff
                self.tel_pack.event("retry", seam="pack", block=b, attempt=a,
                                    backoff_s=backoff)
            sp.set(attempts=self.max_attempts, exhausted=True)
        if not self.cfg.degrade:
            raise BlockFailure(b, "pack", err)
        return _PackedBlock(None, np.zeros(self.cfg.cohort, np.int64),
                            penalty, fails)

    def solve_block(self, b: int, packed: _PackedBlock, ids, dropped,
                    alpha0_np, omega0) -> _SolvedBlock:  # worker: solve
        """SOLVE STAGE wrapper: retry with capped backoff, then degrade.

        Runs on the single solve worker like ``solve`` itself, so every
        clock charge (pack penalty first, then per-attempt backoff, then
        any injected fold delay) lands in block order.  Injected faults
        fire BEFORE the solve call -- the trace is untouched, so a retry
        redraws nothing.  A REAL solve exception that leaves the trace
        mid-round cannot be retried deterministically (the round-indexed
        draw streams would desync) and fails hard instead.
        """
        if packed.penalty_s > 0.0:
            self.trace.charge(packed.penalty_s)
        s: Optional[_SolvedBlock] = None
        fails, err = 0, None
        if packed.data is not None:
            with self.tel_solve.span("solve", block=b,
                                     pack_penalty_s=packed.penalty_s) as sp:
                for a in range(self.max_attempts):
                    if self.plan is not None and self.plan.solve_fails(b, a):
                        err = InjectedFault("solve", b, a)
                    else:
                        try:
                            s = self.solve(b, packed.data, ids, dropped,
                                           alpha0_np, omega0)
                            sp.set(attempts=a + 1)
                            break
                        except Exception as e:  # noqa: BLE001 -- retried,
                            err = e  # then raised/degraded (never dropped)
                            if self.trace.mid_round:
                                raise BlockFailure(b, "solve", e) from e
                    fails += 1
                    backoff = (self.plan.backoff(a) if self.plan is not None
                               else backoff_delay(a))
                    self.trace.charge(backoff)
                    self.tel_solve.event("retry", seam="solve", block=b,
                                         attempt=a, backoff_s=backoff)
                if s is None:
                    sp.set(attempts=self.max_attempts, exhausted=True)
                else:
                    self.tel_solve.counter("blocks_solved").inc()
        if s is None:
            if not self.cfg.degrade:
                raise BlockFailure(b, "solve", err)
            s = self._degraded_block(b, ids)
        s.retries = fails
        s.pack_retries = packed.retries
        if self.plan is not None:
            delay = self.plan.fold_delay(b)
            if delay > 0.0:
                self.trace.charge(delay)
                s.elapsed_s = self.trace.elapsed_s
        if self._ckpt is not None:
            s.clock = self.trace.clock_state()
        return s

    def _degraded_block(self, b: int, ids) -> _SolvedBlock:  # worker: solve
        """Dropped-node semantics for an exhausted block (Assumption 2).

        The entire cohort is treated as failed: ``participated`` all False,
        so the fold applies NO state update (h_t -> 0 exactly as a
        schedule-dropped client).  Crucially the trace still commits
        ``inner_rounds`` zero-step rounds at this block's rate scale --
        the SAME draw-set a solved block consumes -- so the RNG stream
        position after block b is independent of the fault plan and every
        later block redraws identically.
        """
        cfg = self.cfg
        self.trace.set_rate_scale(self.rate_mult[ids])
        zeros = np.zeros(cfg.cohort, np.int64)
        with self.tel_solve.span("degrade", block=b,
                                 inner_rounds=cfg.inner_rounds):
            for _ in range(cfg.inner_rounds):
                self.trace.begin_round()
                self.trace.commit(zeros)
        return _SolvedBlock(
            W=np.zeros((cfg.cohort, self.d), np.float32),
            alpha=np.zeros((cfg.cohort, self.n_pad), np.float32),
            participated=np.zeros(cfg.cohort, bool), max_steps=0,
            dual=0.0, primal=0.0, gap=0.0,
            elapsed_s=self.trace.elapsed_s, degraded=True)

    def fold(self, b: int, ids: np.ndarray, sizes: np.ndarray,
             s: _SolvedBlock) -> None:  # worker: main
        """MAIN THREAD: fold block b (schedule order, via the merger)."""
        with self.tel.span("fold", block=b, degraded=s.degraded,
                           staleness=b - 1 - self.merger.merged_through):
            if s.degraded:
                # a degraded block solved nothing: record the last real
                # metrics (carried forward, like a flat-lined monitor) --
                # the state update below is a no-op because participated is
                # all False.  The carry-forward is announced, not silent:
                # history analysis can tell a flat-lined row from a real one
                self.stats.degraded_blocks += 1
                self.tel.counter("blocks_degraded").inc()
                self.tel.counter("degraded_metrics_carried").inc()
                self.tel.event("degraded_metrics_carried", block=b,
                               dual=self._last_metrics[0],
                               primal=self._last_metrics[1],
                               gap=self._last_metrics[2])
                s = dataclasses.replace(
                    s, dual=self._last_metrics[0],
                    primal=self._last_metrics[1], gap=self._last_metrics[2])
            else:
                self._last_metrics = (s.dual, s.primal, s.gap)
            self.stats.retries += s.retries + s.pack_retries
            if s.retries + s.pack_retries:
                self.tel.counter("retries").inc(s.retries + s.pack_retries)
            self.tel.counter("blocks_folded").inc()
            self.participation[ids[s.participated]] += 1
            if s.capture_s is not None:
                self.graph_captures.append(s.capture_s)
            self.merger.fold(b, ids, s.W, s.alpha, sizes, s.participated)
            new = ids[s.participated & ~self.seen[ids]]
            self.seen[new] = True
            self.n_seen += new.size
            if self.record[b]:
                h = self.history
                h["round"].append(b)
                h["dual"].append(s.dual)
                h["primal"].append(s.primal)
                h["gap"].append(s.gap)
                h["time"].append(s.elapsed_s)
                h["round_max_steps"].append(s.max_steps)
                h["unique_clients"].append(self.n_seen)
            if self._ckpt is not None:
                self._last_clock = s.clock
                self._launch_snaps.pop(b, None)
                if self._ckpt.due(b):
                    self._ckpt.save(self, b)
        if self.on_fold is not None:
            self.on_fold(b)

    def checkpoint_on_failure(self) -> None:  # worker: main
        """Force-save the merge frontier before a failure propagates.

        Called from the loops' exception paths: everything folded so far is
        durable, so a crash loses at most the in-flight work (recomputed
        deterministically on resume).  No-op without a checkpointer or
        before the first fold.
        """
        if self._ckpt is not None and self.merger.merged_through >= 0:
            self._ckpt.save(self, self.merger.merged_through)

    def result(self) -> CohortRunResult:  # worker: main
        graphs = self.graph_captures
        return CohortRunResult(
            relationship=self.state, history=self.history,
            trace=self.trace,  # reprolint: ok T301
            schedule=self.schedule, rate_mult=self.rate_mult,
            participation=self.participation, fault_stats=self.stats,
            resumed_from=self.resumed_from, captures=len(graphs),
            capture_s=sum(graphs) if graphs else None)


def _run_blocks_sequential(loop: _BlockLoop, rounds: int) -> None:
    """The reference block loop: pack, solve, fold, one block at a time.

    On failure (a ``BlockFailure`` escaping the retry/degradation ladder,
    or anything unexpected) the merge frontier is force-checkpointed before
    the exception propagates, so at most the failing block is recomputed.
    """
    try:
        for b in range(loop.start_block, rounds):
            ids, dropped, alpha0, omega0 = loop.launch_args(b)
            packed = loop.pack_block(b)
            loop.fold(b, ids, packed.sizes,
                      loop.solve_block(b, packed, ids, dropped, alpha0,
                                       omega0))
    except BaseException:
        loop.checkpoint_on_failure()
        raise


def _run_blocks_pipelined(loop: _BlockLoop, rounds: int, overlap: int,
                          staleness: int) -> None:
    """Depth-``overlap`` software pipeline with staleness-bounded merging.

    Single-worker pools make each stage serial (pack order, solve order,
    and therefore trace order are all schedule order); the drain rule
    ``while in_flight > staleness`` makes merge points a pure function of
    block counts, so the schedule of state reads -- and hence the result --
    is deterministic for every (overlap, staleness), and identical to the
    sequential loop at staleness 0.

    Failure hardening: completed predecessors of a failing block have
    already folded (the drain folds strictly in schedule order, so the
    failure surfaces only after every earlier result was consumed); the
    exception path then cancels all queued pack work
    (``shutdown(cancel_futures=True)``), force-checkpoints the merge
    frontier, and re-raises promptly -- it never blocks on in-flight solve
    futures, and a crash loses at most the un-folded in-flight blocks
    (recomputed deterministically on resume).  NOTHING extra is folded
    here: folding ahead of the drain schedule would shift the launch-time
    state later blocks observe and break resume bit-identity.
    """
    depth = max(1, overlap)
    start = loop.start_block
    packs = ThreadPoolExecutor(1, "cohort-pack")
    solves = ThreadPoolExecutor(1, "cohort-solve")
    pack_q = deque(
        packs.submit(loop.pack_block, b)
        for b in range(start, min(start + depth, rounds)))
    in_flight: deque = deque()   # (block, ids, sizes, future)
    try:
        for b in range(start, rounds):
            # queue depths at each launch: how full the pack prefetch and
            # solved-but-unmerged windows actually ran (pipeline health)
            loop.tel.histogram("pack_queue_depth").observe(len(pack_q))
            loop.tel.histogram("in_flight_depth").observe(len(in_flight))
            while len(in_flight) > staleness:
                fb, fids, fsizes, fut = in_flight.popleft()
                loop.fold(fb, fids, fsizes, fut.result())
            packed = pack_q.popleft().result()
            if b + depth < rounds:
                pack_q.append(packs.submit(loop.pack_block, b + depth))
            ids, dropped, alpha0, omega0 = loop.launch_args(b)
            if not loop.merger.admissible(b):
                raise RuntimeError(   # drain rule broken -- never expected
                    f"block {b} launching with merge frontier "
                    f"{loop.merger.merged_through} (staleness {staleness})")
            in_flight.append((b, ids, packed.sizes, solves.submit(
                loop.solve_block, b, packed, ids, dropped, alpha0, omega0)))
        while in_flight:
            fb, fids, fsizes, fut = in_flight.popleft()
            loop.fold(fb, fids, fsizes, fut.result())
    except BaseException:
        for f in pack_q:
            f.cancel()
        packs.shutdown(wait=False, cancel_futures=True)
        solves.shutdown(wait=False, cancel_futures=True)
        loop.checkpoint_on_failure()
        raise
    packs.shutdown()
    solves.shutdown()


def _run_cohort(pop: Population, reg: Regularizer, cfg: CohortConfig,
                telemetry: Optional[obs.Telemetry] = None) -> CohortRunResult:
    """Run cross-device MOCHA: ``cfg.rounds`` sampled-cohort blocks.

    ``reg`` plays its usual two roles, both in cohort/cluster space: its
    ``coupling`` turns the expanded K x K Omega block into the subproblem
    coupling inside each ``run_mocha`` call, and its ``update_omega`` is
    the central Omega step applied to the (k, d) centroid matrix every
    ``omega_update_every`` blocks.

    ``cfg.overlap`` / ``cfg.staleness`` select the block loop: the
    sequential reference at (1, 0), the overlapped pipeline otherwise
    (bit-identical at staleness 0 -- see the module docstring).
    """
    if cfg.overlap < 1:
        raise ValueError(f"need overlap >= 1, got {cfg.overlap}")
    if cfg.staleness < 0:
        raise ValueError(f"need staleness >= 0, got {cfg.staleness}")
    loop = _BlockLoop(pop, reg, cfg, telemetry=telemetry)
    if cfg.overlap > 1 or cfg.staleness > 0:
        _run_blocks_pipelined(loop, cfg.rounds, cfg.overlap, cfg.staleness)
    else:
        _run_blocks_sequential(loop, cfg.rounds)
    return loop.result()
