"""Held-out evaluation: per-client error and mean loss.

  * cross-silo  -- the per-client table of a single run's final ``W``
                   (``evaluate_run``);
  * sweep grids -- the same table for every (regularizer, shuffle) cell and
                   the (R, S) mean-error grid the Table-1/4 protocol selects
                   over (``evaluate_grid``).

Both return an ``EvalReport``, the ``evaluation`` block of
``repro_torch.api.Report``.  The JAX package's cohort evaluation
(``holdout_client_ids``, ``evaluate_cohort``) belongs to the cohort path,
which the port does not have yet (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dual import FederatedData, per_task_error
from repro_torch.core.losses import Loss

Tensor = torch.Tensor

#: per-client metric columns the harness can compute
METRICS = ("error", "loss")


@dataclasses.dataclass
class EvalReport:
    """Held-out evaluation tables (the ``Report.evaluation`` block).

    ``per_client`` maps a column name to an array over clients: ``(m,)``
    for a single run, ``(R, S, m)`` for a grid.  ``grid`` (grids only) is
    the (R, S) mean held-out error used for model selection.  ``summary``
    holds flat scalars.  ``per_cluster`` is the cohort path's (always None
    here).
    """

    per_client: Dict[str, np.ndarray]
    per_cluster: Optional[Dict[str, np.ndarray]] = None
    grid: Optional[np.ndarray] = None
    summary: Dict[str, float] = dataclasses.field(default_factory=dict)


def _check_metrics(metrics: Tuple[str, ...]) -> Tuple[str, ...]:
    bad = [m for m in metrics if m not in METRICS]
    if bad:
        raise ValueError(f"unknown eval metrics {bad}; available: {METRICS}")
    return tuple(metrics)


def _client_metrics(loss: Loss, W: Tensor, X: Tensor, y: Tensor,
                    mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(error, mean loss) per client for one (m, d) weight matrix; the
    error is ``dual.per_task_error``, the repo's one definition of it."""
    err = per_task_error(None, W, X, y, mask)
    z = torch.einsum("tid,td->ti", X, W)
    cnt = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    lval = torch.sum(loss.value(z, y) * mask, dim=-1) / cnt
    return err, lval


def _weights(W, like: Tensor) -> Tensor:
    """Weights (a tensor or an array) as float32 on ``like``'s device."""
    if not isinstance(W, Tensor):
        W = torch.from_numpy(np.array(W, dtype=np.float32))
    return W.to(device=like.device, dtype=torch.float32)


def evaluate_run(W, holdout: FederatedData, loss: Loss,
                 metrics: Tuple[str, ...] = METRICS) -> EvalReport:
    """Per-client held-out table for a single run's final (m, d) weights."""
    metrics = _check_metrics(metrics)
    err, lval = _client_metrics(loss, _weights(W, holdout.X), holdout.X,
                                holdout.y, holdout.mask)
    table: Dict[str, np.ndarray] = {
        "client": np.arange(holdout.m),
        "n_holdout": holdout.n_t.cpu().numpy().astype(np.int64),
    }
    summary = {}
    if "error" in metrics:
        table["error"] = err.cpu().numpy()
        summary["mean_error"] = float(np.mean(table["error"]))
    if "loss" in metrics:
        table["loss"] = lval.cpu().numpy()
        summary["mean_loss"] = float(np.mean(table["loss"]))
    return EvalReport(per_client=table, summary=summary)


def evaluate_grid(W, holdout: FederatedData, loss: Loss,
                  metrics: Tuple[str, ...] = METRICS) -> EvalReport:
    """Held-out tables for a (R, S, m, d) sweep result.

    ``holdout`` is the stacked (S, m, n, d) test split matching the sweep's
    shuffle axis.  The (R, S) ``grid`` of mean errors is what the Table-1/4
    protocol minimizes per shuffle.
    """
    metrics = _check_metrics(metrics)
    W = _weights(W, holdout.X)
    if W.dim() != 4 or holdout.X.dim() != 4:
        raise ValueError(
            f"evaluate_grid expects (R, S, m, d) weights and stacked "
            f"holdout; got {tuple(W.shape)} and {tuple(holdout.X.shape)}")
    R, S = W.shape[:2]
    cells = [[_client_metrics(loss, W[r, s], holdout.X[s], holdout.y[s],
                              holdout.mask[s]) for s in range(S)]
             for r in range(R)]
    err = torch.stack([torch.stack([c[0] for c in row]) for row in cells])
    lval = torch.stack([torch.stack([c[1] for c in row]) for row in cells])
    table: Dict[str, np.ndarray] = {}
    if "error" in metrics:
        table["error"] = err.cpu().numpy()
    if "loss" in metrics:
        table["loss"] = lval.cpu().numpy()
    grid = torch.mean(err, dim=-1).cpu().numpy()
    best = grid.min(axis=0)        # best regularizer per shuffle
    summary = {
        "mean_error": float(grid.mean()),
        "best_mean_error": float(best.mean()),
        "best_stderr": float(best.std() / np.sqrt(max(len(best), 1))),
    }
    return EvalReport(per_client=table, grid=grid, summary=summary)
