"""Fault tolerance for the cohort runtime: deterministic chaos, retry with
graceful degradation, and checkpoint/resume.

The port's copy of the JAX package's ``repro.cohort.resilience``.

MOCHA's robustness story (the paper's Section 4, Fig 3; Assumption 2:
convergence holds whenever the per-client failure probability p < 1) is
about *modeled* faults -- stragglers, dropped nodes, bounded-inexactness
local work.  This module makes the PROCESS itself share that story; three
pieces, all bit-reproducible:

  * ``FaultPlan`` -- a pre-sampled fault schedule, the same counter-based
    presample discipline as ``CohortSampler.presample``: every injected
    failure is a pure function of ``(seed, block, attempt)`` on its own
    domain-separated stream, so chaos runs replay exactly.  Faults inject
    at the real seams of the block pipeline: the pack worker (a staged
    client read failing), the solve call (a device program / client cohort
    failing at block b, attempt a), and the fold hand-off (a delayed
    merge).

  * retry with capped backoff, then GRACEFUL DEGRADATION -- a failing
    block retries up to ``CohortConfig.max_retries``, each failed attempt
    charging capped-exponential backoff to the simulated clock
    (``SystemsTrace.charge``).  A block that exhausts its budget degrades
    to the theory's dropped-node semantics instead of crashing: the fold
    sees ``participated = False`` everywhere (h_t -> 0), so the factored
    state takes NO update from the failed block -- exactly Assumption 2's
    covered case.  A plan whose degraded-block fraction pushes the
    effective per-client failure probability toward 1 aborts up front with
    an Assumption-2 diagnostic (``validate_assumption2``).

  * ``CohortCheckpointer`` -- periodic atomic snapshots of the ENTIRE
    mutable run state (factored ClusterOmega + LRU cache, merge frontier,
    history, seen/participation, fault counters, the trace clock + RNG
    stream position, and the launch snapshots of in-flight blocks) through
    ``train.checkpoint``'s numpy archives, keyed by a config fingerprint.
    ``resume`` restores all of it and the run continues BIT-IDENTICALLY to
    an uninterrupted one, at every (overlap, staleness).

Determinism under faults rests on two invariants the driver maintains:

  1. a DEGRADED block consumes exactly the same trace draw-set as a solved
     one (``inner_rounds`` begin_round/commit pairs of zero steps), so the
     round-indexed RNG stream position after block b never depends on the
     fault plan;
  2. backoff / fold delays advance the clock through ``charge`` -- no
     draws -- so they cost simulated time without perturbing any
     pre-sampled schedule.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.train import checkpoint as _ckpt
from repro_torch.utils.dist import writes_files
from repro_torch.utils.timing import tick

#: domain-separation tag for the fault plan's SeedSequence entropy
_FAULT_STREAM = 0x666C74   # "flt"

#: ``validate_assumption2`` aborts when the effective per-client failure
#: probability (schedule dropout composed with planned degraded blocks)
#: reaches this -- "approaches 1" made concrete and testable
ASSUMPTION2_MAX_P = 0.95

#: backoff defaults used when retries are enabled without a FaultPlan
#: (real, un-injected failures still cost simulated time)
DEFAULT_BACKOFF_S = 1.0
DEFAULT_BACKOFF_CAP_S = 60.0


def backoff_delay(attempt: int, base_s: float = DEFAULT_BACKOFF_S,
                  cap_s: float = DEFAULT_BACKOFF_CAP_S) -> float:
    """Capped exponential backoff charged after failed attempt ``attempt``."""
    return float(min(base_s * (2.0 ** attempt), cap_s))


class InjectedFault(RuntimeError):
    """A FaultPlan-scheduled failure (seam in {'pack', 'solve'})."""

    def __init__(self, seam: str, block: int, attempt: int):
        super().__init__(
            f"injected {seam} fault at block {block}, attempt {attempt}")
        self.seam, self.block, self.attempt = seam, int(block), int(attempt)


class BlockFailure(RuntimeError):
    """A block exhausted its retry budget with degradation disabled.

    Carries enough to diagnose and resume: the failing block, the stage it
    failed in, and the last underlying cause.  When checkpointing is on the
    driver force-saves the merge frontier before raising this, so at most
    the in-flight work is recomputed on resume.
    """

    def __init__(self, block: int, stage: str,
                 cause: Optional[BaseException] = None):
        super().__init__(
            f"block {block} failed in {stage!r} after exhausting retries "
            f"(cause: {cause!r}); enable CohortConfig.degrade for "
            "dropped-node degradation or raise max_retries")
        self.block, self.stage, self.cause = int(block), stage, cause


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static description of a run's injected-fault process.

    Probabilities are per (block, attempt), independent, pre-sampled --
    a transient fault at attempt a says nothing about attempt a + 1.  The
    ``*_fail_blocks`` tuples are HARD faults: every attempt at those blocks
    fails (the interrupt/crash story the resume tests and benchmarks use).
    """

    pack_fail_prob: float = 0.0    # per-(block, attempt) pack-worker fault
    solve_fail_prob: float = 0.0   # per-(block, attempt) solve-call fault
    fold_delay_prob: float = 0.0   # per-block delayed fold hand-off
    fold_delay_s: float = 1.0      # simulated seconds per delayed fold
    backoff_s: float = DEFAULT_BACKOFF_S        # retry backoff base
    backoff_cap_s: float = DEFAULT_BACKOFF_CAP_S  # retry backoff cap
    pack_fail_blocks: Tuple[int, ...] = ()   # hard faults: all attempts
    solve_fail_blocks: Tuple[int, ...] = ()  # hard faults: all attempts
    seed: int = 0                  # plan stream (domain-separated from run)

    def validate(self) -> None:
        for name in ("pack_fail_prob", "solve_fail_prob", "fold_delay_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"need 0 <= {name} <= 1, got {v}")
        for name in ("fold_delay_s", "backoff_s", "backoff_cap_s"):
            if getattr(self, name) < 0.0:
                raise ValueError(
                    f"need {name} >= 0, got {getattr(self, name)}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The whole run's fault schedule, drawn up front.

    Same presample discipline as ``CohortSampler.presample``: one
    domain-separated stream (``_FAULT_STREAM``), everything indexed by
    ``(block, attempt)``, so injection sites are a pure function of the
    seeds -- independent of thread timing, pipeline depth, and retry
    interleaving.  Because the plan is total, the set of blocks that WILL
    exhaust their retries is known at construction, which is what lets the
    Assumption-2 guard abort before any work runs.
    """

    pack_fail: np.ndarray    # (rounds, attempts) bool
    solve_fail: np.ndarray   # (rounds, attempts) bool
    fold_delay_s: np.ndarray  # (rounds,) float64 injected fold delay
    backoff_s: float
    backoff_cap_s: float

    @classmethod
    def presample(cls, cfg: FaultConfig, seed: int, rounds: int,
                  max_retries: int) -> "FaultPlan":
        """Draw the full (rounds, max_retries + 1) fault schedule."""
        cfg.validate()
        if max_retries < 0:
            raise ValueError(f"need max_retries >= 0, got {max_retries}")
        attempts = int(max_retries) + 1
        rng = np.random.default_rng(
            np.random.SeedSequence([_FAULT_STREAM, seed, cfg.seed]))
        pack = rng.random((rounds, attempts)) < cfg.pack_fail_prob
        solve = rng.random((rounds, attempts)) < cfg.solve_fail_prob
        delay = np.where(rng.random(rounds) < cfg.fold_delay_prob,
                         cfg.fold_delay_s, 0.0)
        for b in cfg.pack_fail_blocks:
            if 0 <= b < rounds:
                pack[b, :] = True
        for b in cfg.solve_fail_blocks:
            if 0 <= b < rounds:
                solve[b, :] = True
        return cls(pack_fail=pack, solve_fail=solve, fold_delay_s=delay,
                   backoff_s=float(cfg.backoff_s),
                   backoff_cap_s=float(cfg.backoff_cap_s))

    @property
    def rounds(self) -> int:
        return self.pack_fail.shape[0]

    @property
    def attempts(self) -> int:
        return self.pack_fail.shape[1]

    def pack_fails(self, block: int, attempt: int) -> bool:
        return bool(self.pack_fail[block, attempt])

    def solve_fails(self, block: int, attempt: int) -> bool:
        return bool(self.solve_fail[block, attempt])

    def fold_delay(self, block: int) -> float:
        return float(self.fold_delay_s[block])

    def backoff(self, attempt: int) -> float:
        return backoff_delay(attempt, self.backoff_s, self.backoff_cap_s)

    def degraded_blocks(self) -> np.ndarray:
        """(rounds,) bool: blocks whose pack OR solve fails EVERY attempt
        (these degrade to dropped-node folds, or raise with degrade off)."""
        return self.pack_fail.all(axis=1) | self.solve_fail.all(axis=1)

    def validate_assumption2(self, dropout: float) -> None:
        """Abort up front when the plan pushes effective failure toward 1.

        A degraded block drops its ENTIRE cohort, so the effective
        per-client failure probability composes the schedule dropout with
        the planned degraded-block fraction:

            p_eff = 1 - (1 - dropout) * (1 - degraded_fraction)

        Assumption 2 needs p < 1 for convergence; we draw the practical
        line at ``ASSUMPTION2_MAX_P`` and name the remedy in the error.
        """
        frac = float(self.degraded_blocks().mean()) if self.rounds else 0.0
        p_eff = 1.0 - (1.0 - float(dropout)) * (1.0 - frac)
        if p_eff >= ASSUMPTION2_MAX_P:
            raise ValueError(
                f"Assumption 2 violated: effective per-client failure "
                f"probability {p_eff:.3f} >= {ASSUMPTION2_MAX_P} "
                f"(dropout={dropout}, degraded block fraction {frac:.3f} "
                f"over {self.attempts} attempt(s)/block).  Convergence "
                "needs p < 1 -- raise max_retries, lower the fault "
                "probabilities, or lower dropout.")


@dataclasses.dataclass
class FaultStats:
    """Per-run fault accounting, folded on the MAIN thread only and stamped
    into Report provenance."""

    retries: int = 0           # failed attempts that were retried (pack+solve)
    degraded_blocks: int = 0   # blocks folded as zero participation


def run_fingerprint(pop: Any, reg: Any, cfg: Any) -> str:
    """12-hex fingerprint of WHAT a cohort run computes, for resume checks.

    Covers the population identity, the regularizer, and the cohort config
    with the resilience knobs themselves NORMALIZED OUT (faults, retries,
    checkpoint cadence/location, resume flag): a run interrupted by an
    injected crash must be resumable with the fault injection removed and
    the cadence changed -- those knobs alter when state is saved, never
    what is computed.  The telemetry knobs are normalized out for the same
    reason: observation never changes what is computed (the repro_torch.obs
    determinism contract), so a run must be resumable with tracing toggled.
    """
    base = dataclasses.replace(
        cfg, faults=None, max_retries=0, degrade=False,
        checkpoint_every=0, checkpoint_dir=None, resume=False,
        telemetry=False, trace_dir=None)
    ident = (dataclasses.astuple(pop.spec), int(pop.seed),
             type(reg).__name__,
             dataclasses.asdict(reg) if dataclasses.is_dataclass(reg)
             else repr(reg),
             dataclasses.asdict(base))
    blob = json.dumps(ident, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class CohortCheckpointer:
    """Periodic atomic snapshots of a ``_BlockLoop``'s mutable state.

    Storage is ``train.checkpoint``'s atomic numpy archives (write-temp +
    rename, ``step_<block>.ckpt``), one flat dict of FIXED-SHAPE arrays --
    shapes are pure functions of the config, so the strict restore
    validation applies leaf by leaf.  The schema:

      * factored state: ``omega_k/centroids/counts/assign`` + the LRU cache
        flattened in recency order (``cache_ids/cache_n/cache_alpha/
        cache_delta``);
      * run cursor: ``cursor`` (merge frontier), ``n_seen``, ``seen``,
        ``participation``, the padded history matrix + row count, the
        carry-forward metrics, and the fault counters;
      * the simulated clock: trace RNG stream position + elapsed/busy time
        (``SystemsTrace.clock_state``), captured at the END of the
        checkpointed block's solve;
      * pipeline state: launch snapshots (warm alpha + expanded Omega) of
        every launched-but-unfolded block, at most ``staleness + 1`` of
        them -- what makes resume bit-identical at staleness >= 1, because
        those blocks already read OLDER state than a restore could
        reconstruct;
      * ``config_hash``: ``run_fingerprint`` bytes, validated on resume.

    Save points run on the MAIN thread inside ``fold`` (cadence) or the
    failure path (force), so every snapshot is a consistent frontier state.
    """

    def __init__(self, directory: str, every: int, fingerprint: str,
                 telemetry: Optional[obs.Telemetry] = None):
        if not directory:
            raise ValueError(
                "checkpointing needs CohortConfig.checkpoint_dir")
        if every < 0:
            raise ValueError(f"need checkpoint_every >= 0, got {every}")
        self.directory = str(directory)
        self.every = int(every)
        self.fingerprint = str(fingerprint)
        # save points run on the MAIN thread (fold / the failure path), so
        # the checkpoint instruments below are single-writer like the rest
        self._tel = telemetry if telemetry is not None else obs.NULL_TELEMETRY

    # -- schema -------------------------------------------------------------

    def _like(self, loop: Any) -> Dict[str, np.ndarray]:
        """Zero template pinning every leaf's shape and dtype."""
        cfg = loop.cfg
        m = loop.state.m
        k, d = loop.state.k, loop.state.d
        K, n_pad = cfg.cohort, loop.n_pad
        C = loop.state.cache_clients
        H = len(loop.history)
        S1 = cfg.staleness + 1
        return {
            "assign": np.zeros(m, np.int32),
            "cache_alpha": np.zeros((C, n_pad), np.float32),
            "cache_delta": np.zeros((C, d), np.float32),
            "cache_ids": np.zeros(C, np.int64),
            "cache_n": np.zeros(C, np.int64),
            "centroids": np.zeros((k, d), np.float32),
            "config_hash": np.zeros(len(self.fingerprint), np.uint8),
            "counts": np.zeros(k, np.int64),
            "cursor": np.zeros((), np.int64),
            "degraded_blocks": np.zeros((), np.int64),
            "elapsed_s": np.zeros((), np.float64),
            "hist": np.zeros((H, cfg.rounds), np.float64),
            "hist_rows": np.zeros((), np.int64),
            "last_metrics": np.zeros(3, np.float64),
            "n_seen": np.zeros((), np.int64),
            "node_busy_s": np.zeros(K, np.float64),
            "omega_k": np.zeros((k, k), np.float64),
            "participation": np.zeros(m, np.int64),
            "retries": np.zeros((), np.int64),
            "rng": np.zeros(6, np.uint64),
            "seen": np.zeros(m, bool),
            "snap_alpha": np.zeros((S1, K, n_pad), np.float32),
            "snap_blocks": np.zeros(S1, np.int64),
            "snap_omega": np.zeros((S1, K, K), np.float32),
        }

    def _snapshot(self, loop: Any, block: int) -> Dict[str, np.ndarray]:
        cfg = loop.cfg
        clock = loop._last_clock
        if clock is None:
            raise RuntimeError(
                f"checkpoint at block {block} without a clock snapshot")
        keys = list(loop.history)
        rows = len(loop.history[keys[0]])
        hist = np.zeros((len(keys), cfg.rounds), np.float64)
        for i, key in enumerate(keys):
            hist[i, :rows] = loop.history[key]
        S1 = cfg.staleness + 1
        snaps = sorted(loop._launch_snaps)
        if len(snaps) > S1:
            raise RuntimeError(
                f"{len(snaps)} in-flight launch snapshots exceed the "
                f"staleness bound {S1}")
        snap_blocks = np.full(S1, -1, np.int64)
        snap_alpha = np.zeros((S1, cfg.cohort, loop.n_pad), np.float32)
        snap_omega = np.zeros((S1, cfg.cohort, cfg.cohort), np.float32)
        for i, sb in enumerate(snaps):
            alpha, omega = loop._launch_snaps[sb]
            snap_blocks[i] = sb
            snap_alpha[i] = alpha
            snap_omega[i] = omega
        tree = loop.state.snapshot(loop.n_pad)
        tree.update({
            "config_hash": np.frombuffer(self.fingerprint.encode(),
                                         np.uint8).copy(),
            "cursor": np.int64(block),
            "degraded_blocks": np.int64(loop.stats.degraded_blocks),
            "elapsed_s": np.asarray(clock["elapsed_s"], np.float64),
            "hist": hist, "hist_rows": np.int64(rows),
            "last_metrics": np.asarray(loop._last_metrics, np.float64),
            "n_seen": np.int64(loop.n_seen),
            "node_busy_s": np.asarray(clock["node_busy_s"], np.float64),
            "participation": loop.participation.copy(),
            "retries": np.int64(loop.stats.retries),
            "rng": np.asarray(clock["rng"], np.uint64),
            "seen": loop.seen.copy(),
            "snap_alpha": snap_alpha, "snap_blocks": snap_blocks,
            "snap_omega": snap_omega,
        })
        return tree

    # -- save / restore -----------------------------------------------------

    def save(self, loop: Any, block: int) -> str:
        """Atomic snapshot of the frontier state after folding ``block``.
        Under a process group only rank 0 writes it (every rank holds the
        same state, and records the same span and metrics); the others
        return its path.  A resume on another rank's host needs the
        directory on a shared file system."""
        with self._tel.span("checkpoint", block=block) as sp:
            t0 = tick()
            data = _ckpt.encode(block, self._snapshot(loop, block))
            path = (_ckpt.write(self.directory, block, data) if writes_files()
                    else _ckpt.step_path(self.directory, block))
            save_s = tick() - t0
            size = len(data)
            sp.set(bytes=size)
            self._tel.counter("checkpoint_saves").inc()
            self._tel.counter("checkpoint_bytes").inc(size)
            self._tel.histogram("checkpoint_save_s").observe(save_s)
        return path

    def due(self, block: int) -> bool:
        """Cadence: save after folding every ``every``-th block."""
        return self.every > 0 and (block + 1) % self.every == 0

    def restore_into(self, loop: Any) -> int:
        """Install the latest snapshot; returns the first block to run.

        Strict: missing checkpoints and fingerprint mismatches raise with
        the remedy named (resume is only defined against the same
        computation -- see ``run_fingerprint``).
        """
        tree, step = _ckpt.restore(self.directory, self._like(loop),
                                   as_numpy=True)
        saved = bytes(np.asarray(tree["config_hash"], np.uint8)).decode()
        if saved != self.fingerprint:
            raise ValueError(
                f"checkpoint config hash {saved} does not match this run's "
                f"{self.fingerprint}: resume must use the same population, "
                "regularizer, and cohort config (resilience knobs excluded)")
        cursor = int(tree["cursor"])
        if cursor != step:
            raise ValueError(
                f"checkpoint step {step} disagrees with cursor {cursor}")
        loop.state.restore_state(tree)
        loop.merger.merged_through = cursor
        keys = list(loop.history)
        rows = int(tree["hist_rows"])
        int_keys = ("round", "round_max_steps", "unique_clients")
        for i, key in enumerate(keys):
            vals = tree["hist"][i, :rows]
            loop.history[key] = [
                int(v) if key in int_keys else float(v) for v in vals]
        loop.seen = np.asarray(tree["seen"], bool).copy()
        loop.n_seen = int(tree["n_seen"])
        loop.participation = np.asarray(tree["participation"],
                                        np.int64).copy()
        loop.stats.retries = int(tree["retries"])
        loop.stats.degraded_blocks = int(tree["degraded_blocks"])
        loop._last_metrics = tuple(float(v) for v in tree["last_metrics"])
        loop.trace.restore_clock({
            "rng": tree["rng"], "elapsed_s": tree["elapsed_s"],
            "node_busy_s": tree["node_busy_s"]})
        loop._last_clock = loop.trace.clock_state()
        snaps = {}
        for i, sb in enumerate(np.asarray(tree["snap_blocks"], np.int64)):
            if sb >= 0:
                snaps[int(sb)] = (
                    np.asarray(tree["snap_alpha"][i], np.float32).copy(),
                    np.asarray(tree["snap_omega"][i], np.float32).copy())
        loop._resume_snaps = snaps
        return cursor + 1
