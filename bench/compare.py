"""The comparison that decides ``correct``: the program's outputs of one
run against the plain reference's (``bench/reference.py``).

Each number has its limit in ``bench/limits/<workload>.json``; PERF.md
gives the readings every limit was set from.

  * ``W_gap``: ||W - W_ref||_F / ||W_ref||_F of each (lambda, shuffle)
    cell's final per-task models, the median over the run's cells;
  * ``omega_gap``: the same of each cell's final task relationship Omega;
  * ``objective_gap``: the larger of |P - P_ref| and |D - D_ref| over
    |P_ref|, the final primal and dual objectives.
    Each of the three is the median over the run's cells.  A single run
    has one cell;
  * ``W_gap_max``, ``omega_gap_max``, ``objective_gap_max`` (where a run
    has more than one cell): the worst cell among those with lambda at
    most ``COUPLED``, so that a fault in a few cells shows.  The cells
    above it are held by the medians alone: at lambda 0.3 and 1 the
    models nearly cancel (W is small beside the terms that sum to it),
    and float32 alone, the reference's as the program's, leaves those
    cells' gaps as large as the control's and swinging from seed to seed
    (PERF.md);
  * ``heldout_excess``: held-out points a task's reported error counts
    wrong, or right, against the sign of x . w that float64 gives for the
    program's own W, beyond the points whose margin lies within float32
    rounding of zero (an exact comparison: limit 0);
  * ``budget_mismatch`` (where the run reports its executed budgets): the
    (round, task) budgets that differ from the reference's (exact: 0).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from bench import reference

#: the largest lambda whose cells the worst-cell numbers hold
COUPLED = 0.1


def _rel(a, b) -> np.ndarray:
    """||a - b||_F / ||b||_F of every cell: (R, S, ...) -> (R, S)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    flat = a.shape[:2] + (-1,)
    diff = np.linalg.norm((a - b).reshape(flat), axis=-1)
    return diff / np.maximum(np.linalg.norm(b.reshape(flat), axis=-1), 1e-30)


def per_cell(out: dict, ref: dict) -> Dict[str, np.ndarray]:
    """The (R, S) gaps of every cell."""
    return {
        "W_gap": _rel(out["W"], ref["W"]),
        "omega_gap": _rel(out["omega"], ref["omega"]),
        "objective_gap": np.maximum(np.abs(out["primal"] - ref["primal"]),
                                    np.abs(out["dual"] - ref["dual"]))
        / np.abs(ref["primal"]),
    }


def numbers(out: dict, ref: dict, test,
            lams: Sequence[float]) -> Dict[str, float]:
    """The compared numbers of one run's outputs ``out`` (W, omega, primal,
    dual, error (R, S, m), budgets or None) against ``ref``
    (``reference.solve``), with the held-out split ``test`` and the run's
    ``lams`` (R)."""
    cells = per_cell(out, ref)
    got = {k: float(np.median(v)) for k, v in cells.items()}
    held = np.asarray(lams) <= COUPLED
    if cells["W_gap"].size > 1 and held.any():
        got.update({f"{k}_max": float(np.max(v[held]))
                    for k, v in cells.items()})
    wrong, near = reference.heldout_wrong(out["W"], test)
    count = np.maximum(test.mask.sum(-1).cpu().numpy(), 1.0)   # (S, m)
    reported = np.rint(np.asarray(out["error"], np.float64) * count[None])
    got["heldout_excess"] = float(np.max(
        np.maximum(np.abs(reported - wrong) - near, 0)))
    if out.get("budgets") is not None:
        got["budget_mismatch"] = float(np.sum(
            np.asarray(out["budgets"]) != ref["budgets"]))
    return got


def judge(got: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit.  A number without a limit, or a limit without its number, is
    not correct."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in got.items()}
    correct = set(got) == set(limits) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return bool(correct), checks
