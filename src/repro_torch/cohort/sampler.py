"""Per-round cohort selection over a client population.

The port's copy of the JAX package's ``repro.cohort.sampler`` (numpy, so
the schedules are the JAX package's bit for bit).

Cross-device MOCHA never runs all m clients: each block (outer round)
executes on a sampled cohort of K clients.  Selection is PRE-SAMPLED for
the whole run -- exactly the discipline ``theta.round_key_schedule`` /
``presample_budgets`` established for budgets -- so the schedule is a pure
function of ``(seed, round)``, the per-block inner driver stays
device-resident (no state-dependent control flow), and two invocations of
a run draw identical cohorts.

Three selection behaviors, composable:

  * ``uniform``  -- K clients uniformly without replacement per round;
  * ``weighted`` -- availability-weighted without replacement (Gumbel
                    top-K over log-weights): weights derive from the
                    SystemsTrace device-heterogeneity law
                    (``systems_model.population_rates``) -- faster devices
                    check in more often, the selection bias the
                    cross-device surveys flag;
  * ``dropout``  -- per-(selected client, round) failure: the slot stays in
                    the cohort but its budget is forced to 0, the paper's
                    H_t -> 0 dropped node (theta_t^h = 1) at population
                    scale (``theta.drop_masked_budgets`` applies the mask).

Assumption 2 (p_max < 1) is validated just as ``BudgetConfig`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: domain-separation tag for the schedule's SeedSequence entropy
_SCHEDULE_STREAM = 0x636F68   # "coh"

SAMPLERS = ("uniform", "weighted")


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Static description of a run's cohort-selection process."""

    m: int                     # population size
    cohort: int                # K clients per round
    kind: str = "uniform"      # uniform | weighted
    dropout: float = 0.0       # per-(selected client, round) failure prob
    #: (m,) availability weights (kind="weighted"); normalized internally.
    #: Typically ``systems_model.population_rates(m, systems_cfg)``.
    weights: Optional[np.ndarray] = None

    def validate(self) -> None:
        if self.kind not in SAMPLERS:
            raise ValueError(f"sampler kind {self.kind!r} not in {SAMPLERS}")
        if not 0 < self.cohort <= self.m:
            raise ValueError(
                f"cohort size {self.cohort} not in (0, m={self.m}]")
        if self.dropout >= 1.0:
            raise ValueError(
                f"dropout={self.dropout} violates Assumption 2 (p_max < 1); "
                "no cohort member would ever report back.")
        if self.kind == "weighted":
            if self.weights is None:
                raise ValueError("kind='weighted' needs availability weights")
            w = np.asarray(self.weights, np.float64)
            if w.shape != (self.m,) or np.any(w <= 0.0):
                raise ValueError(
                    f"weights must be positive with shape ({self.m},)")

    def presample(self, seed: int, rounds: int) -> "CohortSchedule":
        """Draw the full (rounds, K) selection + drop schedule up front."""
        self.validate()
        rng = np.random.default_rng(
            np.random.SeedSequence([_SCHEDULE_STREAM, seed]))
        ids = np.empty((rounds, self.cohort), np.int64)
        if self.kind == "weighted":
            logw = np.log(np.asarray(self.weights, np.float64))
        for h in range(rounds):
            if self.kind == "uniform":
                ids[h] = rng.choice(self.m, self.cohort, replace=False)
            else:
                # Gumbel top-K == weighted sampling without replacement,
                # O(m) per round (no O(m) sequential re-normalization)
                z = logw + rng.gumbel(size=self.m)
                top = np.argpartition(z, self.m - self.cohort)[-self.cohort:]
                ids[h] = top[np.argsort(-z[top])]   # deterministic order
        dropped = rng.random((rounds, self.cohort)) < self.dropout
        return CohortSchedule(ids=ids, dropped=dropped)


@dataclasses.dataclass(frozen=True)
class CohortSchedule:
    """Pre-sampled selection for one run: who, when, and who failed."""

    ids: np.ndarray        # (rounds, K) int64 client ids
    dropped: np.ndarray    # (rounds, K) bool: selected but never reported

    @property
    def rounds(self) -> int:
        return self.ids.shape[0]

    @property
    def cohort(self) -> int:
        return self.ids.shape[1]

    def with_all_dropped(self, block: int) -> "CohortSchedule":
        """Copy with every slot of ``block`` marked schedule-dropped.

        Fault-harness / test helper: an all-dropped block exercises the
        theory's H_t -> 0 boundary (every selected client fails), which the
        driver must fold as ZERO participation -- no centroid motion, no
        ``seen``/``participation`` increment, on both block loops.
        Selection ``ids`` are shared, the drop mask is copied.
        """
        if not 0 <= block < self.rounds:
            raise ValueError(
                f"block {block} outside schedule of {self.rounds} rounds")
        dropped = self.dropped.copy()
        dropped[block, :] = True
        return CohortSchedule(ids=self.ids, dropped=dropped)

    def participation_counts(self, m: int) -> np.ndarray:
        """(m,) how often each client was selected and not schedule-dropped.

        An UPPER BOUND on actual participation: in-round budget zeroing
        (``BudgetConfig.drop_prob``, semi_sync deadline caps) happens below
        the schedule and is not visible here -- use
        ``CohortRunResult.participation`` for the driver's executed truth.
        O(m) memory."""
        counts = np.zeros(m, np.int64)
        np.add.at(counts, self.ids[~self.dropped], 1)
        return counts
