"""Simulated federated wall-clock (paper eq. 30 / Appendix E).

    Time(h, t) = FLOPs(h, t) / ClockRate(t) + Comm(h, t)

Communication = latency + message_bytes / bandwidth, with network presets whose
comm : comp ratios span roughly one to three orders of magnitude (3G / LTE /
WiFi), matching the paper's simulation methodology.  The per-round time of a
synchronous method is the max over participating nodes; MOCHA's global clock
cycle instead *caps* the round and nodes fit their budget to it.

Two layers:

  * stateless helpers (``comm_time``, ``round_time_sync``,
    ``round_time_clock_cycle``) -- the original scalar model, kept for
    mini-batch baselines and back-compat;
  * the event-driven per-node simulator (``SystemsConfig`` + ``SystemsTrace``)
    that the unified MOCHA driver and the Fig-1/2/3 harnesses consume: each
    node has its own clock rate, per-round straggler tails, and per-round
    network draws, and the round-completion policy (``sync`` wait-for-all vs
    ``semi_sync`` clock-cycle deadline) is a property of the trace, not of
    call sites.

All constants are explicit and documented so the benchmark is reproducible.

This module is numpy only: the port keeps its own copy of the JAX
package's ``repro.core.systems_model``, consuming the same PCG64 draws, so
the simulated clock and the semi_sync step caps of a port run are those of
the reference run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    latency_s: float       # per round-trip message
    bandwidth_Bps: float   # bytes / second


# Representative mobile-network figures (paper refs [52, 20, 48, 9, 38]).
NETWORKS: Dict[str, Network] = {
    "3g": Network("3g", latency_s=0.100, bandwidth_Bps=0.125e6),    # ~1 Mbit/s
    "lte": Network("lte", latency_s=0.050, bandwidth_Bps=1.25e6),   # ~10 Mbit/s
    "wifi": Network("wifi", latency_s=0.010, bandwidth_Bps=6.25e6), # ~50 Mbit/s
}

#: effective scalar throughput of a 2017-era mobile CPU on unvectorized
#: double-precision SDCA updates (~100 MFLOP/s sustained; a 2 GHz core
#: retires far fewer useful FLOPs on branchy scalar loops)
CLOCK_FLOPS = 1.0e8

#: FLOPs per SDCA coordinate step in d dimensions: dot(x, w) + q*dot(x, u)
#: (2 * 2d), delta arithmetic (O(1)), u += delta x (2d) -> ~6d.
SDCA_STEP_FLOPS = lambda d: 6.0 * d

#: FLOPs per primal SGD example: grad dot + axpy -> ~4d.
SGD_STEP_FLOPS = lambda d: 4.0 * d


def comm_time(network: Network, msg_bytes: float) -> float:
    return network.latency_s + msg_bytes / network.bandwidth_Bps


def round_time_sync(step_counts: np.ndarray, d: int, network: Network,
                    step_flops=SDCA_STEP_FLOPS,
                    clock_flops: float = CLOCK_FLOPS) -> float:
    """Synchronous round: server waits for the slowest participating node.

    step_counts: (m,) local steps actually performed (0 = dropped; a dropped
    node costs no compute but the round still pays one message slot, since the
    server's clock cycle bounds the wait).
    """
    msg_bytes = 8.0 * d  # v_t up + w_t down, 4-byte floats each way
    compute = step_counts.astype(np.float64) * step_flops(d) / clock_flops
    return float(np.max(compute)) + comm_time(network, msg_bytes)


def round_time_clock_cycle(step_counts: np.ndarray, d: int, network: Network,
                           step_flops=SDCA_STEP_FLOPS,
                           clock_flops: float = CLOCK_FLOPS) -> float:
    """MOCHA round under a global clock cycle.

    The central node fixes a deadline; every node fits its local work to it, so
    the round costs the deadline (the max *feasible* compute among nodes that
    used it) plus one communication slot.  Numerically this equals
    ``round_time_sync`` -- the difference is *which* step_counts arise: MOCHA's
    controller shrinks budgets instead of letting slow nodes run long.
    """
    return round_time_sync(step_counts, d, network, step_flops, clock_flops)


# ---------------------------------------------------------------------------
# Event-driven per-node systems simulator
# ---------------------------------------------------------------------------

POLICIES = ("sync", "semi_sync")

#: domain-separation tag for the population-rates stream: a SystemsTrace
#: seeded with the same cfg.seed must NOT share raw draws with the
#: availability weights (entangled streams would couple which clients get
#: sampled to which slots straggle)
_RATES_STREAM = 0x726174   # "rat"


def population_rates(m: int, cfg: "SystemsConfig",
                     seed: Optional[int] = None) -> np.ndarray:
    """Per-client static clock-rate multipliers for an m-client population.

    The same U[rate_lo, rate_hi] device-heterogeneity law ``SystemsTrace``
    draws per node, but as bare multipliers (no ``clock_flops`` factor) and
    for populations far larger than any single trace: the cross-device
    cohort subsystem samples availability weights from these and injects the
    sampled clients' rates into a cohort-slot trace via
    ``SystemsTrace.set_rate_scale``.  O(m) memory -- the only per-client
    hardware state the population carries.  Drawn on a domain-separated
    stream so a trace built from the same ``cfg.seed`` shares no raw draws
    with these weights.
    """
    rng = np.random.default_rng(np.random.SeedSequence(
        [_RATES_STREAM, cfg.seed if seed is None else seed]))
    return rng.uniform(cfg.rate_lo, cfg.rate_hi, m)


def presample_policy_caps(m: int, d: int, cfg: "SystemsConfig",
                          rounds: int) -> Optional[np.ndarray]:
    """The (rounds, m) semi_sync deadline-cap matrix a FRESH trace derives.

    Caps are a pure function of ``(SystemsConfig, m, d, rounds)`` -- the
    trace RNG is seeded by ``cfg.seed``, never by run state -- so every
    grid cell of a sweep sharing one ``SystemsConfig`` sees the SAME cap
    matrix, which is exactly what the sequential fallback produces when it
    builds one fresh ``SystemsTrace`` per cell.  The vmapped sweep
    (core/sweep.py) folds this matrix into its pre-sampled budgets, making
    semi_sync grids batchable cell-for-cell bit-identically to the
    fallback.  Returns None under ``sync`` (no caps).
    """
    if cfg.policy != "semi_sync":
        return None
    return SystemsTrace(m, d, cfg).presample_caps(rounds)


@dataclasses.dataclass(frozen=True)
class SystemsConfig:
    """Static description of a federation's systems environment.

    Defaults reproduce the original scalar model exactly: homogeneous
    ``CLOCK_FLOPS`` nodes, no straggler tail, deterministic network, ``sync``
    round policy.  Every knob maps to a paper concept:

      * ``rate_lo``/``rate_hi``: per-*node* static clock-rate multipliers drawn
        once, U[lo, hi] -- device heterogeneity (Sec. 3.3).
      * ``straggler_prob``/``straggler_mult``: per-(node, round) tail event
        slowing that node's round by ``mult`` -- transient stragglers
        (background load, thermal throttling).
      * ``comm_jitter``: per-(node, round) multiplicative latency jitter in
        U[1, 1+jitter] -- network variance.
      * ``policy='semi_sync'`` + ``clock_cycle_s``: MOCHA's global clock cycle;
        the trace derives per-node *feasible* step caps each round and the
        round costs the deadline, not the straggler (Sec. 3.4).
    """

    network: str = "lte"
    policy: str = "sync"
    clock_cycle_s: float = 0.0        # deadline; required > 0 for semi_sync
    clock_flops: float = CLOCK_FLOPS
    rate_lo: float = 1.0
    rate_hi: float = 1.0
    straggler_prob: float = 0.0
    straggler_mult: float = 10.0
    comm_jitter: float = 0.0
    seed: int = 0

    def validate(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.policy == "semi_sync" and self.clock_cycle_s <= 0.0:
            raise ValueError("semi_sync policy requires clock_cycle_s > 0")
        if not (0.0 < self.rate_lo <= self.rate_hi):
            raise ValueError("need 0 < rate_lo <= rate_hi")


@dataclasses.dataclass
class RoundEvent:
    """One federated round as seen by the simulated clock."""

    round: int
    steps: np.ndarray        # (m,) coordinate steps actually performed
    compute_s: np.ndarray    # (m,) per-node compute time (0 for dropped)
    comm_s: np.ndarray       # (m,) per-node round-trip message time
    finish_s: np.ndarray     # (m,) offset within the round when node finished
    start_s: float           # global clock when the round began
    duration_s: float        # what the global clock advanced
    cap_steps: Optional[np.ndarray]  # semi_sync: feasible steps under deadline
    dropped: np.ndarray      # (m,) bool, steps == 0


class SystemsTrace:
    """Event-driven wall-clock simulator for one federated run.

    Protocol (two-phase so the *controller* can react to this round's systems
    state before committing work, exactly the paper's theta_t^h story):

        cap = trace.begin_round()        # draw rates/network; semi_sync cap
        budgets = min(budgets, cap)      # controller fits work to the cycle
        ...run the round...
        trace.commit(step_counts)        # advance the clock, log the event

    ``advance(steps)`` is the one-shot begin+commit helper for sync call
    sites.  ``elapsed_s`` is the global simulated clock; ``events`` the full
    per-node log Fig-1/2/3 consume.
    """

    def __init__(self, m: int, d: int,
                 cfg: SystemsConfig = SystemsConfig(),
                 step_flops=SDCA_STEP_FLOPS,
                 msg_bytes: Optional[float] = None):
        cfg.validate()
        self.m, self.d, self.cfg = m, d, cfg
        self.network = NETWORKS[cfg.network]
        self._rng = np.random.default_rng(cfg.seed)
        # static per-node clock rates (device heterogeneity)
        self.rates = cfg.clock_flops * self._rng.uniform(
            cfg.rate_lo, cfg.rate_hi, m)
        self.step_flops_d = float(step_flops(d))
        self.msg_bytes = 8.0 * d if msg_bytes is None else float(msg_bytes)
        self.elapsed_s = 0.0
        self.node_busy_s = np.zeros(m)
        self.events: List[RoundEvent] = []
        self._round_rates: Optional[np.ndarray] = None
        self._round_comm: Optional[np.ndarray] = None
        self._cap: Optional[np.ndarray] = None
        self._rate_scale: Optional[np.ndarray] = None

    # -- per-round protocol -------------------------------------------------

    def set_rate_scale(self, scale: Optional[np.ndarray]) -> None:
        """Install per-slot clock-rate multipliers applied from the next
        ``begin_round`` until changed (``None`` clears them).

        Cross-device cohorts re-bind each trace slot to a different sampled
        client every block; the cohort driver injects that client's hardware
        rate here (``population_rates``) so the simulated clock charges the
        *client's* compute rate, not a static per-slot one.  Mid-round calls
        are rejected: the scale must be stable across a
        ``begin_round``/``commit`` pair (and across a scanned segment's
        ``presample_caps`` + ``replay``, which reuse ``begin_round``)."""
        if self._round_rates is not None:
            raise RuntimeError("set_rate_scale called mid-round")
        if scale is not None:
            scale = np.asarray(scale, np.float64)
            if scale.shape != (self.m,):
                raise ValueError(
                    f"rate_scale shape {scale.shape} != ({self.m},)")
            if np.any(scale <= 0.0):
                raise ValueError("rate_scale must be positive")
        self._rate_scale = scale

    def begin_round(self) -> Optional[np.ndarray]:
        """Draw this round's systems state.

        Returns per-node feasible step caps under the clock-cycle deadline
        (``semi_sync``) or None (``sync``: no cap, the server waits).
        """
        if self._round_rates is not None:
            raise RuntimeError("begin_round called twice without commit")
        cfg = self.cfg
        slow = self._rng.random(self.m) < cfg.straggler_prob
        rates = (self.rates if self._rate_scale is None
                 else self.rates * self._rate_scale)
        self._round_rates = rates / np.where(slow, cfg.straggler_mult, 1.0)
        lat = self.network.latency_s * (
            1.0 + cfg.comm_jitter * self._rng.random(self.m))
        self._round_comm = lat + self.msg_bytes / self.network.bandwidth_Bps
        if cfg.policy == "semi_sync":
            self._cap = np.floor(
                cfg.clock_cycle_s * self._round_rates / self.step_flops_d
            ).astype(np.int64)
            return self._cap
        self._cap = None
        return None

    def commit(self, step_counts: np.ndarray) -> float:
        """Advance the clock by one round of ``step_counts`` local steps."""
        if self._round_rates is None:
            self.begin_round()
        steps = np.asarray(step_counts, dtype=np.float64)
        if steps.shape != (self.m,):
            raise ValueError(f"step_counts shape {steps.shape} != ({self.m},)")
        if self._cap is not None:
            # the deadline is physical: a node stops computing when the clock
            # cycle ends, whatever budget the caller asked for (keeps the
            # clock honest and utilization <= 1 for un-capped callers)
            steps = np.minimum(steps, self._cap)
        compute = steps * self.step_flops_d / self._round_rates
        comm = self._round_comm
        # a dropped node (0 steps) costs no compute but still one message slot
        # (the server's round bookkeeping pings every node)
        finish = compute + comm
        if self.cfg.policy == "semi_sync":
            # the deadline bounds compute; nodes were budget-capped to fit it
            duration = self.cfg.clock_cycle_s + float(np.max(comm))
        else:
            duration = float(np.max(finish))
        self.events.append(RoundEvent(
            round=len(self.events), steps=steps.astype(np.int64),
            compute_s=compute, comm_s=comm.copy(), finish_s=finish,
            start_s=self.elapsed_s, duration_s=duration,
            cap_steps=None if self._cap is None else self._cap.copy(),
            dropped=steps == 0))
        self.elapsed_s += duration
        self.node_busy_s += compute
        self._round_rates = self._round_comm = self._cap = None
        return duration

    def advance(self, step_counts: np.ndarray) -> float:
        """One-shot begin_round + commit (sync call sites)."""
        if self._round_rates is None:
            self.begin_round()
        return self.commit(step_counts)

    def presample_caps(self, rounds: int) -> Optional[np.ndarray]:
        """Peek the next ``rounds`` rounds' semi_sync step caps WITHOUT
        consuming them.

        Caps are round-indexed (a pure function of the trace RNG stream),
        never state-dependent, so a device-resident driver can fold them into
        its pre-sampled budget matrix and replay the trace afterwards: the
        RNG state is snapshotted and restored, so the subsequent
        ``begin_round``/``commit`` replay sees exactly the draws previewed
        here.  Returns None under the ``sync`` policy (no caps).
        """
        if self.cfg.policy != "semi_sync":
            return None
        if self._round_rates is not None:
            raise RuntimeError("presample_caps called mid-round")
        snapshot = self._rng.bit_generator.state
        caps = np.empty((rounds, self.m), np.int64)
        for r in range(rounds):
            # reuse begin_round itself so the draw order matches the later
            # replay by construction, then discard the un-committed round
            caps[r] = self.begin_round()
            self._round_rates = self._round_comm = self._cap = None
        self._rng.bit_generator.state = snapshot
        return caps

    def replay(self, step_matrix: np.ndarray) -> None:
        """Commit a recorded (rounds, m) executed-step matrix round by round.

        Used by the scanned driver: budgets ran on device, the clock is
        retimed afterwards.  Equivalent to the loop driver's interleaved
        begin_round/commit because both the trace draws and the committed
        steps are round-indexed (DESIGN.md section 4).
        """
        for row in np.asarray(step_matrix):
            self.begin_round()
            self.commit(row)

    # -- resilience hooks (repro.cohort.resilience) -------------------------

    @property
    def mid_round(self) -> bool:
        """True between ``begin_round`` and ``commit``.

        The resilience layer refuses to retry a solve whose failure left
        the trace mid-round: the round-indexed draw streams would desync
        and determinism is lost -- such a block fails hard instead.
        """
        return self._round_rates is not None

    def charge(self, seconds: float) -> float:
        """Advance the simulated clock by out-of-round overhead seconds.

        The resilience layer charges retry backoff and injected fold delays
        here, so fault handling costs simulated time exactly like any other
        systems effect.  No round event is logged and no RNG draw is
        consumed -- the round-indexed draw streams (and hence every
        pre-sampled schedule) are untouched by fault handling.
        """
        if self._round_rates is not None:
            raise RuntimeError("charge called mid-round")
        s = float(seconds)
        if s < 0.0:
            raise ValueError(f"charge needs seconds >= 0, got {s}")
        self.elapsed_s += s
        return s

    def clock_state(self) -> Dict[str, np.ndarray]:
        """Fixed-shape host snapshot of the simulated clock.

        Captured between rounds (raises mid-round) for cohort checkpoints:
        the PCG64 stream position packed as (6,) uint64 words, the global
        clock, and per-node busy time.  ``restore_clock`` of this snapshot
        makes every subsequent round redraw identically, which is what makes
        resumed runs bit-identical.  The per-round event log is NOT part of
        the snapshot -- a resumed trace's ``events`` restarts empty (the
        cumulative clock lives in ``elapsed_s`` / the run history).
        """
        if self._round_rates is not None:
            raise RuntimeError("clock_state called mid-round")
        st = self._rng.bit_generator.state
        if st.get("bit_generator") != "PCG64":
            raise NotImplementedError(
                f"clock_state supports PCG64 only, got "
                f"{st.get('bit_generator')!r}")
        lo = (1 << 64) - 1
        s, inc = st["state"]["state"], st["state"]["inc"]
        rng = np.array([s & lo, (s >> 64) & lo, inc & lo, (inc >> 64) & lo,
                        int(st["has_uint32"]), int(st["uinteger"])],
                       np.uint64)
        return {"rng": rng, "elapsed_s": np.float64(self.elapsed_s),
                "node_busy_s": self.node_busy_s.copy()}

    def restore_clock(self, snap: Dict[str, np.ndarray]) -> None:
        """Install a ``clock_state`` snapshot (same ``SystemsConfig``)."""
        if self._round_rates is not None:
            raise RuntimeError("restore_clock called mid-round")
        rng = np.asarray(snap["rng"], np.uint64)
        st = self._rng.bit_generator.state
        st["state"]["state"] = int(rng[0]) | (int(rng[1]) << 64)
        st["state"]["inc"] = int(rng[2]) | (int(rng[3]) << 64)
        st["has_uint32"] = int(rng[4])
        st["uinteger"] = int(rng[5])
        self._rng.bit_generator.state = st
        self.elapsed_s = float(snap["elapsed_s"])
        self.node_busy_s = np.asarray(snap["node_busy_s"],
                                      np.float64).copy()

    # -- analysis -----------------------------------------------------------

    def utilization(self) -> np.ndarray:
        """Fraction of the elapsed clock each node spent computing."""
        return self.node_busy_s / max(self.elapsed_s, 1e-12)

    def times(self) -> np.ndarray:
        """Cumulative clock at the END of each committed round."""
        return np.cumsum([e.duration_s for e in self.events])

    def summary(self) -> Dict[str, float]:
        if not self.events:
            return {"rounds": 0, "elapsed_s": 0.0}
        durs = np.asarray([e.duration_s for e in self.events])
        drops = np.asarray([e.dropped.sum() for e in self.events])
        return {
            "rounds": len(self.events),
            "elapsed_s": float(self.elapsed_s),
            "mean_round_s": float(durs.mean()),
            "p95_round_s": float(np.percentile(durs, 95)),
            "mean_dropped": float(drops.mean()),
            "min_utilization": float(self.utilization().min()),
            "max_utilization": float(self.utilization().max()),
        }
