"""MTL regularizers R(W, Omega) and their coupling matrices (paper App. B).

For the W-step with Omega fixed, every regularizer of the paper is the
quadratic form R(W) = tr(W Abar W^T) for an SPD m x m coupling ``Abar``, so
MOCHA's dual algebra lives in m x m space:

    K           = Abar^{-1}
    R*(X alpha) = (1/4) sum_{t,t'} K_{t t'} <v_t, v_{t'}>
    W(alpha)    = (1/2) K V
    sigma'_t    = gamma sum_{t'} |K_{t t'}| / K_{t t}            (Remark 5)

  * ``MeanRegularized`` -- eq. (2)/(11), Omega = (I - 11^T/m)^2 fixed;
  * ``Clustered``       -- eq. (12), water-filling Omega update;
  * ``Probabilistic``   -- eq. (14), Omega <- (W W^T)^(1/2) / tr(...);
  * ``Graphical``       -- eq. (15) without the W l1 term, ISTA with a PSD
                           projection.

Matrices are float32 on the device of the tensors they are given;
``init_omega`` takes the device (the card unless asked otherwise).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.device import resolve_device

Tensor = torch.Tensor

_JITTER = 1e-8


def _eye(m: int, like: Tensor) -> Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _sym(x: Tensor) -> Tensor:
    return 0.5 * (x + x.T)


def _psd_sqrt(s: Tensor, floor: float = 1e-10) -> Tensor:
    """Matrix square root of a PSD matrix via eigh."""
    w, q = torch.linalg.eigh(_sym(s))
    w = torch.clamp_min(w, floor)
    return (q * torch.sqrt(w)) @ q.T


def spd_inverse(a: Tensor, floor: float = 1e-10) -> Tensor:
    """Inverse of an SPD matrix with eigenvalue flooring."""
    w, q = torch.linalg.eigh(_sym(a))
    w = torch.clamp_min(w, floor)
    return (q / w) @ q.T


class Regularizer:
    """Base class: ``coupling(omega)``, ``penalty``, ``update_omega``."""

    name: str = "base"

    def init_omega(self, m: int, device=None) -> Tensor:
        raise NotImplementedError

    def coupling(self, omega: Tensor) -> Tensor:
        """SPD Abar (m x m) with R(W) = tr(W Abar W^T)."""
        raise NotImplementedError

    def penalty(self, W: Tensor, omega: Tensor) -> Tensor:
        """R(W, Omega) for the primal objective; W is (m, d)."""
        return torch.sum(self.coupling(omega) * (W @ W.T))

    def update_omega(self, W: Tensor, omega: Tensor) -> Tensor:
        """Central Omega-step given W (m, d); fixed by default."""
        return omega

    def K(self, omega: Tensor) -> Tensor:
        return spd_inverse(self.coupling(omega))


@dataclasses.dataclass(frozen=True)
class MeanRegularized(Regularizer):
    """Eq. (2)/(11): all tasks shrink toward their mean.  Omega fixed."""

    lambda1: float = 1.0
    lambda2: float = 1.0
    name: str = "mean"

    def init_omega(self, m: int, device=None) -> Tensor:
        eye = torch.eye(m, device=resolve_device(device))
        c = eye - torch.full_like(eye, 1.0 / m)
        return c @ c

    def coupling(self, omega: Tensor) -> Tensor:
        return (self.lambda1 * omega
                + self.lambda2 * _eye(omega.shape[0], omega))


@dataclasses.dataclass(frozen=True)
class Clustered(Regularizer):
    """Eq. (12): R = lam tr(W (eta I + Omega)^{-1} W^T), Omega in Q(k)."""

    lam: float = 1.0
    eta: float = 0.5
    k: int = 2
    name: str = "clustered"

    def init_omega(self, m: int, device=None) -> Tensor:
        return torch.eye(m, device=resolve_device(device)) * (self.k / m)

    def coupling(self, omega: Tensor) -> Tensor:
        m = omega.shape[0]
        return self.lam * spd_inverse(self.eta * _eye(m, omega) + omega)

    def update_omega(self, W: Tensor, omega: Tensor) -> Tensor:
        """Eigenvalue water-filling on S = W W^T: w_i = clip(sqrt(s_i)/nu -
        eta, 0, 1) with nu found by bisection so that sum w_i = k."""
        svals, q = torch.linalg.eigh(_sym(W @ W.T))
        svals = torch.clamp_min(svals, 0.0)
        root = torch.sqrt(svals + _JITTER)

        def omega_of(nu):
            return torch.clamp(root / nu - self.eta, 0.0, 1.0)

        lo = torch.full((), 1e-8, dtype=W.dtype, device=W.device)
        hi = torch.full((), 1.0, dtype=W.dtype, device=W.device)
        # sum omega_of(nu) decreases in nu: grow hi past the root, bisect
        while float(torch.sum(omega_of(hi))) > self.k:
            hi = hi * 2.0
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            too_big = torch.sum(omega_of(mid)) > self.k
            lo, hi = (torch.where(too_big, mid, lo),
                      torch.where(too_big, hi, mid))
        w = omega_of(0.5 * (lo + hi))
        # cold start (W = 0): no signal in the spectrum; keep the prior
        m = W.shape[0]
        if float(torch.sum(svals)) > 1e-10:
            return (q * w) @ q.T
        return _eye(m, W) * (self.k / m)


@dataclasses.dataclass(frozen=True)
class Probabilistic(Regularizer):
    """Eq. (14): R = lam (sigma^-2 ||W||_F^2 + tr(W Omega^{-1} W^T))."""

    lam: float = 1.0
    sigma2: float = 1.0
    name: str = "probabilistic"

    def init_omega(self, m: int, device=None) -> Tensor:
        return torch.eye(m, device=resolve_device(device)) / m

    def coupling(self, omega: Tensor) -> Tensor:
        m = omega.shape[0]
        return self.lam * (spd_inverse(omega, floor=1e-6)
                           + _eye(m, omega) / self.sigma2)

    def update_omega(self, W: Tensor, omega: Tensor) -> Tensor:
        root = _psd_sqrt(W @ W.T)
        tr = torch.trace(root)
        m = W.shape[0]
        # cold start (W = 0): keep the uninformative prior
        return torch.where(tr > 1e-8, root / torch.clamp_min(tr, 1e-8),
                           _eye(m, W) / m)


@dataclasses.dataclass(frozen=True)
class Graphical(Regularizer):
    """Eq. (15) precision-matrix prior (W l1 term omitted):

        R = lam (sigma^-2 ||W||^2 + tr(W Omega W^T) - d log|Omega|)
            + lam2 ||Omega||_1

    Omega-step: ISTA on tr(S Omega) - d log|Omega| + lam2 ||Omega||_1 with
    S = W W^T, clipping eigenvalues to stay SPD.
    """

    lam: float = 1.0
    sigma2: float = 1.0
    lam2: float = 0.01
    d_scale: float = 1.0   # stands in for d in the -d log|Omega| term
    ista_steps: int = 25
    ista_lr: float = 0.1
    name: str = "graphical"

    def init_omega(self, m: int, device=None) -> Tensor:
        return torch.eye(m, device=resolve_device(device))

    def coupling(self, omega: Tensor) -> Tensor:
        m = omega.shape[0]
        return self.lam * (omega + _eye(m, omega) / self.sigma2)

    def penalty(self, W: Tensor, omega: Tensor) -> Tensor:
        base = super().penalty(W, omega)
        logdet = torch.linalg.slogdet(omega)[1]
        return (base - self.lam * self.d_scale * logdet
                + self.lam2 * torch.sum(torch.abs(omega)))

    def update_omega(self, W: Tensor, omega: Tensor) -> Tensor:
        s_mat = self.lam * (W @ W.T)
        diag = torch.eye(omega.shape[0], dtype=torch.bool,
                         device=omega.device)
        for _ in range(self.ista_steps):
            grad = s_mat - self.lam * self.d_scale * spd_inverse(
                omega, floor=1e-6)
            omega = omega - self.ista_lr * grad
            # soft threshold off the diagonal (graphical-lasso prox)
            off = torch.sign(omega) * torch.clamp_min(
                torch.abs(omega) - self.ista_lr * self.lam2, 0.0)
            omega = torch.where(diag, omega, off)
            w, q = torch.linalg.eigh(_sym(omega))
            omega = (q * torch.clamp_min(w, 1e-4)) @ q.T
        return omega


REGULARIZERS = {
    "mean": MeanRegularized,
    "clustered": Clustered,
    "probabilistic": Probabilistic,
    "graphical": Graphical,
}


def sigma_prime(K: Tensor, gamma: float = 1.0,
                per_task: bool = False) -> Tensor:
    """Lemma 9 / Remark 5 safe subproblem parameter from K = Abar^{-1}:
    sigma'_t = gamma sum_{t'} |K_{t t'}| / K_{t t}, or its max over tasks."""
    diag = torch.diagonal(K)
    per = gamma * (torch.sum(torch.abs(K), dim=1)
                   / torch.clamp_min(diag, _JITTER))
    return per if per_task else torch.max(per)
