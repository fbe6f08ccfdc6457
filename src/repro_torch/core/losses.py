"""Convex losses, their conjugate duals and SDCA coordinate updates.

Each loss ``l(z, y)`` is paired with its conjugate ``l*(-a, y)`` at the
negated dual variable (the paper's dual, eq. 3).  ``Loss.sdca_delta``
solves the per-coordinate data-local subproblem

    min_delta  l*(-(a + delta)) + delta * <x, g> + (q/2) * delta^2 ||x||^2

in closed form (an 8-step scalar Newton for logistic), with
``g = w_t + q * u`` the effective primal point.  Dual feasibility for
y in {-1, +1}: a*y in [0, 1] for hinge, smoothed hinge and logistic; a is
free for squared.  Every function is elementwise on float32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Loss:
    """A convex loss with conjugate dual and SDCA coordinate update."""

    name: str
    #: l(z, y) -> loss
    value: Callable[[Tensor, Tensor], Tensor]
    #: l*(-a, y) -> conjugate at the negated dual variable (finite region)
    conjugate_neg: Callable[[Tensor, Tensor], Tensor]
    #: closed-form / Newton coordinate update, see ``sdca_delta``
    _delta: Callable[[Tensor, Tensor, Tensor, Tensor, float], Tensor]
    #: l is (1/mu)-smooth; 0.0 means non-smooth (hinge)
    mu: float
    #: Lipschitz constant of l in z; inf if unbounded
    lipschitz: float

    def sdca_delta(self, a: Tensor, y: Tensor, xg: Tensor,
                   qxx: Tensor) -> Tensor:
        """Optimal coordinate increment ``delta``.

        ``a``: alpha_i plus the accumulated Delta alpha_i; ``y``: label;
        ``xg``: <x_i, g>; ``qxx``: q * ||x_i||^2.
        """
        return self._delta(a, y, xg, qxx, _EPS)


# hinge: l(z, y) = max(0, 1 - y z);   l*(-a, y) = -a y,  a y in [0, 1]

def _hinge_value(z, y):
    return torch.clamp_min(1.0 - y * z, 0.0)


def _hinge_conj_neg(a, y):
    return -a * y


def _hinge_delta(a, y, xg, qxx, eps):
    abar = a * y
    step = (1.0 - y * xg) / torch.clamp_min(qxx, eps)
    abar_new = torch.clamp(abar + step, 0.0, 1.0)
    return (abar_new - abar) * y


# smoothed hinge (mu-smoothed), l*(-a, y) = -a y + (mu/2)(a y)^2

_SMOOTH_MU = 0.5


def _smooth_hinge_value(z, y, mu=_SMOOTH_MU):
    yz = y * z
    lin = 1.0 - yz - mu / 2.0
    quad = torch.square(torch.clamp_min(1.0 - yz, 0.0)) / (2.0 * mu)
    return torch.where(yz >= 1.0, torch.zeros_like(yz),
                       torch.where(yz <= 1.0 - mu, lin, quad))


def _smooth_hinge_conj_neg(a, y, mu=_SMOOTH_MU):
    ay = a * y
    return -ay + 0.5 * mu * torch.square(ay)


def _smooth_hinge_delta(a, y, xg, qxx, eps, mu=_SMOOTH_MU):
    abar = a * y
    abar_new = torch.clamp(
        (1.0 - y * xg + qxx * abar) / torch.clamp_min(mu + qxx, eps),
        0.0, 1.0)
    return (abar_new - abar) * y


# logistic: l(z, y) = log(1 + exp(-y z))
#   l*(-a, y) = ab log(ab) + (1-ab) log(1-ab),  ab = a y in [0, 1]

def _logistic_value(z, y):
    return torch.logaddexp(torch.zeros_like(z), -y * z)


def _xlogx(p):
    return torch.where(p > 0.0, p * torch.log(torch.clamp_min(p, _EPS)),
                       torch.zeros_like(p))


def _logistic_conj_neg(a, y):
    ab = torch.clamp(a * y, 0.0, 1.0)
    return _xlogx(ab) + _xlogx(1.0 - ab)


def _logistic_delta(a, y, xg, qxx, eps, newton_steps: int = 8):
    """Scalar Newton in ab-space on
    phi'(ab) = log(ab/(1-ab)) + y*xg + qxx*(ab - ab0)."""
    lo = 1e-6
    ab0 = torch.clamp(a * y, lo, 1.0 - lo)
    ab = ab0
    for _ in range(newton_steps):
        g = torch.log(ab) - torch.log1p(-ab) + y * xg + qxx * (ab - ab0)
        h = 1.0 / (ab * (1.0 - ab)) + qxx
        ab = torch.clamp(ab - g / h, lo, 1.0 - lo)
    return (ab - ab0) * y


# squared: l(z, y) = 0.5 (z - y)^2;  l*(-a, y) = 0.5 a^2 - a y

def _squared_value(z, y):
    return 0.5 * torch.square(z - y)


def _squared_conj_neg(a, y):
    return 0.5 * torch.square(a) - a * y


def _squared_delta(a, y, xg, qxx, eps):
    return (y - a - xg) / (1.0 + qxx)


HINGE = Loss("hinge", _hinge_value, _hinge_conj_neg, _hinge_delta,
             mu=0.0, lipschitz=1.0)
SMOOTH_HINGE = Loss("smooth_hinge", _smooth_hinge_value,
                    _smooth_hinge_conj_neg, _smooth_hinge_delta,
                    mu=_SMOOTH_MU, lipschitz=1.0)
LOGISTIC = Loss("logistic", _logistic_value, _logistic_conj_neg,
                _logistic_delta, mu=0.25, lipschitz=1.0)
SQUARED = Loss("squared", _squared_value, _squared_conj_neg, _squared_delta,
               mu=1.0, lipschitz=float("inf"))

LOSSES = {l.name: l for l in (HINGE, SMOOTH_HINGE, LOGISTIC, SQUARED)}


def get_loss(name: str) -> Loss:
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]
