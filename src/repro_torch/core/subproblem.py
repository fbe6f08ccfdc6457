"""Data-local quadratic subproblem (eq. 4) and its SDCA local solver.

The t-th node at round h minimizes, over its own dual block Delta alpha_t:

    G_t(Delta) = sum_i l*(-(alpha_i + Delta_i)) + <w_t(alpha), X_t^T Delta>
               + (q_t / 2) ||X_t^T Delta||^2 + c(alpha)

Node heterogeneity is a per-node step budget ``H_t``: every node runs
``max_steps`` steps and steps past ``H_t`` are masked, which is the same as
stopping early; ``H_t = 0`` is the paper's dropped node.  Real points are
packed to the left of the n_max axis and coordinates are drawn in [0, n_t).

The solver is the JAX package's arithmetic version 2: the drawn coordinate
stream runs in chunks of ``C`` steps with the fused residual ``r = w + q*u``
in one of two residual modes, picked from the static shape by
``_solver_plan``:

  * **carry** (``d > gram_max_d``): per step one length-d reduction
    ``sum(x * r)`` and one axpy ``r += (q*delta) * x``;
  * **gram** (``d <= gram_max_d``): per chunk ``G_c = X_c X_c^T`` and
    ``p_c = X_c r``, then O(C) work per step,
    ``g = p_c[s] + q * sum(G_c[s] * deltas)``; ``r`` is rebuilt once per
    chunk from the chunk's delta column sum.

The chunk's column sum is also its contribution to ``u``.  This module is
the plain PyTorch version of the Hopper SDCA kernel
(``repro_torch.kernels.sdca``): both read the same coordinate stream and
chunk plan.  The batch of tasks is a tensor dimension written out (the JAX
package's ``vmap``), and the step loop runs in Python.

The JAX package keeps two bit-identical accumulator variants (a dense
per-step scatter and a compact per-chunk one) only to steer XLA away from an
O(n) copy per step.  Eager torch updates ``dalpha`` in place, so one variant
is enough here: a repeated coordinate in a chunk reads its running total.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.core.losses import Loss
from repro_torch.utils import prng

Tensor = torch.Tensor

#: chunk length (= Gram window) per residual mode, as in the JAX package
_GRAM_CHUNK = 32
_CARRY_CHUNK_WIDE = 64     # d >= _CARRY_WIDE_D
_CARRY_CHUNK_NARROW = 16
_CARRY_WIDE_D = 512
#: default feature-count crossover between the residual modes;
#: ``REPRO_GRAM_MAX_D`` (env var) or ``Exec.gram_max_d`` override it
_GRAM_MAX_D = 128


def active_gram_max_d() -> int:
    """The residual-mode crossover in effect: ``REPRO_GRAM_MAX_D`` when
    set, else the module default (read per call)."""
    return int(os.environ.get("REPRO_GRAM_MAX_D", _GRAM_MAX_D))


def resolve_gram(d: int, gram_max_d: Optional[int]) -> Optional[bool]:
    """A per-run crossover override as the ``gram`` knob (None = default)."""
    return None if gram_max_d is None else d <= int(gram_max_d)


def _solver_plan(d: int, max_steps: int,
                 gram: Optional[bool] = None) -> Tuple[bool, int]:
    """Static (gram?, chunk) choice shared by the plain solver and the
    kernel: a pure function of the problem shape."""
    if gram is None:
        gram = d <= active_gram_max_d()
    if gram:
        C = _GRAM_CHUNK
    else:
        C = _CARRY_CHUNK_WIDE if d >= _CARRY_WIDE_D else _CARRY_CHUNK_NARROW
    return gram, max(1, min(C, max_steps))


def chunk_idx_stream(idx: Tensor, max_steps: int, C: int) -> Tensor:
    """Zero-pad the drawn stream to a chunk multiple and reshape to chunks.

    The one layout rule of the solver and the kernel: padded positions sit
    at or past ``max_steps``, which is past every clamped budget, so they
    are never live.  Takes ``(max_steps,)`` or batched ``(m, max_steps)``.
    """
    n_chunks = -(-max_steps // C)
    pad = n_chunks * C - max_steps
    idx = torch.nn.functional.pad(idx, (0, pad))
    return idx.reshape(idx.shape[:-1] + (n_chunks, C))


def row_norms(X: Tensor) -> Tensor:
    """``||x_i||^2`` per row: the xnorm2 table every engine reads."""
    return torch.sum(X * X, dim=-1)


def subproblem_value(loss: Loss, X_t: Tensor, y_t: Tensor, mask_t: Tensor,
                     alpha_t: Tensor, dalpha_t: Tensor, w_t: Tensor,
                     q_t: Tensor) -> Tensor:
    """G_t(Delta; v, alpha) minus the constant c(alpha)."""
    conj = loss.conjugate_neg(alpha_t + dalpha_t, y_t) * mask_t
    u = X_t.T @ (dalpha_t * mask_t)
    return torch.sum(conj) + torch.dot(w_t, u) + 0.5 * q_t * torch.dot(u, u)


def draw_coordinates(keys: Tensor, n_t: Tensor, n: int,
                     max_steps: int) -> Tensor:
    """The shared coordinate stream: uniform draws over the n_t real
    (left-packed) points of each task.  Keys (..., 2) and sizes (...) batch
    alike; returns int32 (..., max_steps) in [0, n)."""
    draws = prng.uniform(keys, (max_steps,))
    idx = (draws * torch.clamp_min(n_t, 1.0).unsqueeze(-1)).to(torch.int32)
    return torch.clamp_max(idx, n - 1)


def _draw_coordinates(mask: Tensor, key: Tensor, max_steps: int) -> Tensor:
    return draw_coordinates(key, torch.sum(mask, dim=-1), mask.shape[-1],
                            max_steps)


def batched_local_sdca_idx(loss: Loss, X: Tensor, y: Tensor, mask: Tensor,
                           alpha: Tensor, W: Tensor, q_t: Tensor,
                           budgets: Tensor, idx: Tensor, max_steps: int,
                           xnorm2: Optional[Tensor] = None,
                           gram: Optional[bool] = None
                           ) -> Tuple[Tensor, Tensor]:
    """SDCA local solves of all m tasks over explicit coordinate streams.

    X (m, n, d); y, mask, alpha (m, n); W (m, d); q_t (m,); budgets (m,)
    int; idx (m, max_steps) int.  Returns (dalpha (m, n), u (m, d)) with
    u = X_t^T dalpha_t accumulated from the per-chunk column sums.

    Chunks past every task's budget are skipped: all their steps are dead,
    so they would add exact zeros.
    """
    m, n, d = X.shape
    if xnorm2 is None:
        xnorm2 = row_norms(X)
    gram, C = _solver_plan(d, max_steps, gram)
    budgets = torch.clamp_max(budgets.to(torch.int64), max_steps)
    idx_c = chunk_idx_stream(idx.to(torch.int64), max_steps, C)
    n_live = -(-int(budgets.max()) // C) if m else 0
    rows = torch.arange(m, device=X.device)
    q = q_t.to(X.dtype)
    dalpha = torch.zeros((m, n), dtype=X.dtype, device=X.device)
    u = torch.zeros((m, d), dtype=X.dtype, device=X.device)
    r = W.clone()
    for c in range(n_live):
        ic = idx_c[:, c]                                   # (m, C)
        Xc = X[rows[:, None], ic]                          # (m, C, d)
        yc, xc2 = y[rows[:, None], ic], xnorm2[rows[:, None], ic]
        mc, ac = mask[rows[:, None], ic], alpha[rows[:, None], ic]
        if gram:
            G = torch.bmm(Xc, Xc.transpose(1, 2))          # (m, C, C)
            p = torch.sum(Xc * r[:, None, :], dim=-1)      # (m, C)
        deltas = torch.zeros((m, C), dtype=X.dtype, device=X.device)
        for s in range(C):
            i = ic[:, s]
            a = ac[:, s] + dalpha[rows, i]
            if gram:
                g = p[:, s] + q * torch.sum(G[:, s] * deltas, dim=-1)
            else:
                g = torch.sum(Xc[:, s] * r, dim=-1)
            delta = loss.sdca_delta(a, yc[:, s], g, q * xc2[:, s])
            live = (c * C + s < budgets) & (mc[:, s] > 0)
            delta = delta * live.to(delta.dtype)
            dalpha[rows, i] += delta
            deltas[:, s] = delta
            if not gram:
                r = r + (q * delta)[:, None] * Xc[:, s]
        colsum = torch.sum(Xc * deltas[:, :, None], dim=1)
        if gram:
            r = r + q[:, None] * colsum
        u = u + colsum
    return dalpha, u


def local_sdca_idx(loss: Loss, X_t: Tensor, y_t: Tensor, mask_t: Tensor,
                   alpha_t: Tensor, w_t: Tensor, q_t: Tensor,
                   budget_t: Tensor, idx: Tensor, max_steps: int,
                   xnorm2: Optional[Tensor] = None,
                   gram: Optional[bool] = None) -> Tuple[Tensor, Tensor]:
    """One task's SDCA local solve over an explicit coordinate stream."""
    def one(a):
        return None if a is None else torch.as_tensor(
            a, device=X_t.device).unsqueeze(0)

    dalpha, u = batched_local_sdca_idx(
        loss, one(X_t), one(y_t), one(mask_t), one(alpha_t), one(w_t),
        one(q_t), one(budget_t), one(idx), max_steps, one(xnorm2), gram)
    return dalpha[0], u[0]


def local_sdca(loss: Loss, X_t: Tensor, y_t: Tensor, mask_t: Tensor,
               alpha_t: Tensor, w_t: Tensor, q_t: Tensor, budget_t: Tensor,
               key: Tensor, max_steps: int,
               xnorm2: Optional[Tensor] = None,
               gram: Optional[bool] = None) -> Tuple[Tensor, Tensor]:
    """Up to ``max_steps`` SDCA steps on one task, masked past budget_t,
    over the coordinate stream drawn from ``key``."""
    idx = _draw_coordinates(mask_t, key, max_steps)
    return local_sdca_idx(loss, X_t, y_t, mask_t, alpha_t, w_t, q_t,
                          budget_t, idx, max_steps, xnorm2, gram)


def batched_local_sdca(loss: Loss, X: Tensor, y: Tensor, mask: Tensor,
                       alpha: Tensor, W: Tensor, q_t: Tensor,
                       budgets: Tensor, keys: Tensor, max_steps: int,
                       xnorm2: Optional[Tensor] = None,
                       gram: Optional[bool] = None) -> Tuple[Tensor, Tensor]:
    """``local_sdca`` for all tasks: keys (m, 2), one stream per task."""
    idx = _draw_coordinates(mask, keys, max_steps)
    return batched_local_sdca_idx(loss, X, y, mask, alpha, W, q_t, budgets,
                                  idx, max_steps, xnorm2, gram)


def solve_exact(loss: Loss, X_t: Tensor, y_t: Tensor, mask_t: Tensor,
                alpha_t: Tensor, w_t: Tensor, q_t: Tensor, key: Tensor,
                passes: int = 64) -> Tuple[Tensor, Tensor]:
    """High-accuracy subproblem solution (for theta measurement / tests)."""
    steps = int(passes) * X_t.shape[0]
    budget = torch.tensor(steps, dtype=torch.int64, device=X_t.device)
    return local_sdca(loss, X_t, y_t, mask_t, alpha_t, w_t, q_t, budget,
                      key, steps)


def measure_theta(loss: Loss, X_t: Tensor, y_t: Tensor, mask_t: Tensor,
                  alpha_t: Tensor, w_t: Tensor, q_t: Tensor,
                  dalpha_t: Tensor, key: Tensor,
                  exact_passes: int = 64) -> Tensor:
    """Definition 1: theta = (G(Delta) - G(Delta*)) / (G(0) - G(Delta*))."""
    dstar, _ = solve_exact(loss, X_t, y_t, mask_t, alpha_t, w_t, q_t, key,
                           passes=exact_passes)

    def g(dalpha):
        return subproblem_value(loss, X_t, y_t, mask_t, alpha_t, dalpha,
                                w_t, q_t)

    g_zero, g_delta, g_star = g(torch.zeros_like(alpha_t)), g(dalpha_t), g(
        dstar)
    denom = g_zero - g_star
    return torch.where(denom > 1e-12, (g_delta - g_star) / denom,
                       torch.zeros_like(denom))
