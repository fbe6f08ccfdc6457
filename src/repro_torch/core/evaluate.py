"""Held-out evaluation: per-client error and mean loss.

  * cross-silo  -- the per-client table of a single run's final ``W``
                   (``evaluate_run``);
  * sweep grids -- the same table for every (regularizer, shuffle) cell and
                   the (R, S) mean-error grid the Table-1/4 protocol selects
                   over (``evaluate_grid``);
  * populations -- held-out clients (preferring never-trained ones) scored
                   against their served weights and aggregated by learned
                   cluster (``evaluate_cohort``).

Each returns an ``EvalReport``, the ``evaluation`` block of
``repro_torch.api.Report``.
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
    holds flat scalars.  ``per_cluster`` (cohort runs only) aggregates the
    held-out clients by learned cluster.
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


#: domain-separation tag for the held-out-client draw (never shares raw
#: draws with the schedule / population / rates streams)
_HOLDOUT_STREAM = 0x65766C   # "evl"


def holdout_client_ids(m: int, n_clients: int, seed: int,
                       participation: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Deterministic held-out client sample for population evaluation.

    Prefers clients the run NEVER trained on (``participation == 0``);
    falls back to the full population when coverage was total.  Pure in
    ``(m, n_clients, seed, participation)``: the JAX package's draw, bit
    for bit.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([_HOLDOUT_STREAM, int(seed)]))
    pool = np.arange(m)
    if participation is not None:
        unseen = np.flatnonzero(np.asarray(participation) == 0)
        if unseen.size >= min(n_clients, 1):
            pool = unseen
    n = int(min(n_clients, pool.size))
    return np.sort(rng.choice(pool, size=n, replace=False))


def evaluate_cohort(pop, relationship, loss: Loss, n_clients: int,
                    seed: int = 0,
                    participation: Optional[np.ndarray] = None,
                    metrics: Tuple[str, ...] = METRICS) -> EvalReport:
    """Per-cluster held-out-client evaluation of a cross-device run.

    Materializes ``n_clients`` held-out clients (``holdout_client_ids``),
    scores each on the host against its SERVED weights -- exactly what the
    online tier would answer: ``relationship.client_weights`` applies the
    resolution rule (cluster centroid plus cached personal delta, the bare
    centroid for a cold client) that the serve tier's snapshots apply,
    ``repro_torch.serve.store.resolve_weights`` -- and aggregates by
    learned cluster assignment.
    """
    metrics = _check_metrics(metrics)
    ids = holdout_client_ids(pop.m, n_clients, seed, participation)
    if ids.size == 0:
        return EvalReport(per_client={"client": ids},
                          summary={"holdout_clients": 0.0})
    W = relationship.client_weights(ids)
    errs = np.empty(ids.size)
    lvals = np.empty(ids.size)
    sizes = np.empty(ids.size, np.int64)
    for i, t in enumerate(ids):
        blk = pop.client_block(int(t))
        z = blk.X @ W[i]
        errs[i] = float(np.mean(np.sign(z) != np.sign(blk.y)))
        lvals[i] = float(torch.mean(loss.value(torch.from_numpy(z),
                                               torch.from_numpy(blk.y))))
        sizes[i] = blk.n
    clusters = np.asarray(relationship.assign)[ids]
    table: Dict[str, np.ndarray] = {"client": ids, "cluster": clusters,
                                    "n_holdout": sizes}
    if "error" in metrics:
        table["error"] = errs
    if "loss" in metrics:
        table["loss"] = lvals
    uniq = np.unique(clusters)
    per_cluster: Dict[str, np.ndarray] = {
        "cluster": uniq,
        "n_clients": np.asarray([(clusters == c).sum() for c in uniq]),
    }
    if "error" in metrics:
        per_cluster["mean_error"] = np.asarray(
            [errs[clusters == c].mean() for c in uniq])
    if "loss" in metrics:
        per_cluster["mean_loss"] = np.asarray(
            [lvals[clusters == c].mean() for c in uniq])
    summary = {"holdout_clients": float(ids.size)}
    if "error" in metrics:
        summary["mean_error"] = float(errs.mean())
    if "loss" in metrics:
        summary["mean_loss"] = float(lvals.mean())
    return EvalReport(per_client=table, per_cluster=per_cluster,
                      summary=summary)
