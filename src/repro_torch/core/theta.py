"""Per-node per-round step budgets (theta_t^h, Section 3.4).

Each round a node runs a budget H_t of SDCA coordinate steps:

  * base work:  ``passes`` full passes over the local data;
  * systems:    budget ~ Uniform[lo_frac * n_min, hi_frac * n_min] (App. E);
  * faults:     with probability p_t^h the node drops -> budget 0.

Draws come from the port's threefry PRNG, so the same key gives the budgets
the JAX package draws.  Assumption 2 requires p_max < 1
(``validate_assumption2``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.utils import prng

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Static straggler/fault model for a simulation run."""

    passes: float = 1.0            # baseline: passes * n_t steps per round
    systems_lo: Optional[float] = None   # e.g. 0.1 (high var) / 0.9 (low)
    systems_hi: Optional[float] = None   # typically 1.0
    drop_prob: float = 0.0         # p_t^h, iid per node per round
    never_send_node: Optional[int] = None  # Fig 3: p_t := 1 forever

    def max_steps(self, n_max: int) -> int:
        """Static upper bound on per-round steps."""
        return max(1, int(round(self.passes * n_max)))


def round_budgets(cfg: BudgetConfig, key: Tensor, n_t: Tensor) -> Tensor:
    """Per-node step budgets for one round: int32 (m,) from sizes n_t."""
    m = n_t.shape[0]
    k_sys, k_drop = prng.split(key)
    full = torch.round(cfg.passes * n_t).to(torch.int32)
    base = full
    if cfg.systems_lo is not None:
        n_min = torch.min(n_t)
        lo = cfg.systems_lo * n_min
        hi = (cfg.systems_hi if cfg.systems_hi is not None else 1.0) * n_min
        frac = prng.uniform(k_sys, (m,))
        base = torch.round(lo + frac * (hi - lo)).to(torch.int32)
        base = torch.minimum(base, full)
    budgets = torch.clamp_min(base, 1)
    if cfg.drop_prob > 0.0:
        dropped = prng.bernoulli(k_drop, cfg.drop_prob, (m,))
        budgets = torch.where(dropped, torch.zeros_like(budgets), budgets)
    if cfg.never_send_node is not None:
        budgets = budgets.clone()
        budgets[cfg.never_send_node] = 0
    return budgets


def round_key_schedule(key: Tensor, rounds: int) -> Tuple[Tensor, Tensor]:
    """The loop driver's key chain ``key, k_budget, k_round = split(key,
    3)`` unrolled into two (rounds, 2) key stacks."""
    budget_keys, round_keys = [], []
    for _ in range(rounds):
        key, k_budget, k_round = prng.split(key, 3)
        budget_keys.append(k_budget)
        round_keys.append(k_round)
    return torch.stack(budget_keys), torch.stack(round_keys)


def presample_budgets(cfg: BudgetConfig, budget_keys: Tensor,
                      n_t: Tensor) -> Tensor:
    """The (rounds, m) budget matrix from the per-round budget keys."""
    return torch.stack([round_budgets(cfg, k, n_t) for k in budget_keys])


def drop_masked_budgets(cfg: BudgetConfig, dropped):
    """``budget_fn`` forcing a pre-sampled (rounds, m) drop mask to budget
    0 on top of the BudgetConfig draw (the paper's dropped node)."""
    dropped = torch.as_tensor(dropped, dtype=torch.bool)

    def budget_fn(key: Tensor, n_t: Tensor, h: int) -> Tensor:
        budgets = round_budgets(cfg, key, n_t)
        drop = dropped[h].to(budgets.device)
        return torch.where(drop, torch.zeros_like(budgets), budgets)

    return budget_fn


def validate_assumption2(cfg: BudgetConfig) -> None:
    """Assumption 2: p_max < 1 (every node sends with non-zero chance)."""
    if cfg.drop_prob >= 1.0:
        raise ValueError(
            f"drop_prob={cfg.drop_prob} violates Assumption 2 (p_max < 1); "
            "MOCHA is not guaranteed (or expected) to converge.")
    if cfg.never_send_node is not None:
        warnings.warn(
            "never_send_node set: node drops every round (p_t = 1). This "
            "violates Assumption 2 and MOCHA will converge to the wrong "
            "solution, as in Fig. 3 (green dotted line).", stacklevel=2)
