"""Primal/dual objectives, the w(alpha) map, and the duality gap for (1)/(3).

Padded data layout:
    X     : (m, n_max, d)   X[t, i] = x_t^i  (row vectors)
    y     : (m, n_max)
    mask  : (m, n_max)      1.0 for real points, 0.0 for padding
    alpha : (m, n_max)      dual variables (0 on padding)
    v     : (m, d)          v_t = X_t^T alpha_t

With coupling Abar (m x m SPD) and K = Abar^{-1}:
    R*(X alpha) = (1/4) sum_tt' K_tt' <v_t, v_t'>
    W(alpha)    = (1/2) K V          (rows w_t, shape (m, d))
    D(alpha)    = sum_ti mask * l*(-alpha) + R*(X alpha)         [minimize]
    P(W)        = sum_ti mask * l(x.w_t, y) + tr(W Abar W^T)     [minimize]
    gap(alpha)  = P(W(alpha)) + D(alpha) >= 0, == 0 at optimum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.losses import Loss

Tensor = torch.Tensor


class FederatedData(NamedTuple):
    """Padded per-task data for an m-node federated MTL problem.

    ``xnorm2`` is the per-run ``||x_t^i||^2`` table the SDCA inner loop
    reads every round; ``with_xnorm2`` fills it once per run, ``None``
    means the solvers compute it on the fly with the same formula.
    """

    X: Tensor      # (m, n_max, d)
    y: Tensor      # (m, n_max)
    mask: Tensor   # (m, n_max)
    xnorm2: Optional[Tensor] = None   # (m, n_max) or None

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def n_max(self) -> int:
        return self.X.shape[1]

    @property
    def d(self) -> int:
        return self.X.shape[2]

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def n_t(self) -> Tensor:
        return torch.sum(self.mask, dim=-1)

    @property
    def n_total(self) -> Tensor:
        return torch.sum(self.mask)

    def to(self, device) -> "FederatedData":
        return FederatedData(*(None if a is None else a.to(device)
                               for a in self))


def with_xnorm2(data: FederatedData) -> FederatedData:
    """Fill the per-run ``xnorm2`` table (idempotent)."""
    if data.xnorm2 is not None:
        return data
    from repro_torch.core.subproblem import row_norms
    return data._replace(xnorm2=row_norms(data.X))


class DualState(NamedTuple):
    """MOCHA iterate: dual variables and the communicated v = X alpha."""

    alpha: Tensor  # (m, n_max)
    v: Tensor      # (m, d)


def init_state(data: FederatedData) -> DualState:
    return DualState(alpha=torch.zeros_like(data.y),
                     v=torch.zeros((data.m, data.d), dtype=data.X.dtype,
                                   device=data.X.device))


def compute_v(data: FederatedData, alpha: Tensor) -> Tensor:
    """v_t = sum_i alpha_t^i x_t^i  -- the only cross-node quantity."""
    return torch.einsum("tid,ti->td", data.X, alpha * data.mask)


def primal_weights(K: Tensor, v: Tensor) -> Tensor:
    """W(alpha) = (1/2) K V, rows are per-task weights w_t (m, d)."""
    return 0.5 * K @ v


def r_star(K: Tensor, v: Tensor) -> Tensor:
    """R*(X alpha) = (1/4) sum_tt' K_tt' <v_t, v_t'>."""
    return 0.25 * torch.sum(K * (v @ v.T))


def dual_objective(data: FederatedData, loss: Loss, K: Tensor,
                   alpha: Tensor, v: Tensor) -> Tensor:
    conj = loss.conjugate_neg(alpha, data.y) * data.mask
    return torch.sum(conj) + r_star(K, v)


def primal_objective(data: FederatedData, loss: Loss, abar: Tensor,
                     W: Tensor) -> Tensor:
    z = torch.einsum("tid,td->ti", data.X, W)
    losses = loss.value(z, data.y) * data.mask
    reg = torch.sum(abar * (W @ W.T))
    return torch.sum(losses) + reg


def duality_gap(data: FederatedData, loss: Loss, abar: Tensor, K: Tensor,
                alpha: Tensor, v: Tensor) -> Tensor:
    W = primal_weights(K, v)
    return (primal_objective(data, loss, abar, W)
            + dual_objective(data, loss, K, alpha, v))


def per_task_error(data: FederatedData, W: Tensor, X_test: Tensor,
                   y_test: Tensor, mask_test: Tensor) -> Tensor:
    """Binary classification error per task."""
    z = torch.einsum("tid,td->ti", X_test, W)
    wrong = (torch.sign(z) != torch.sign(y_test)) & (mask_test > 0)
    cnt = torch.clamp_min(torch.sum(mask_test, dim=1), 1.0)
    return torch.sum(wrong, dim=1).to(cnt.dtype) / cnt
