"""Mini-batch baselines from the paper's Fig. 1: Mb-SGD and Mb-SDCA.

Both are synchronous methods with one communication per round on the same
MTL objective (1); they send the same d-sized vector per node per round as
MOCHA, so the time model differs only in local FLOPs and rounds to epsilon.

  * Mb-SGD  (primal): each node returns a mini-batch subgradient of its
    local loss; the server adds the regularizer gradient 2 Abar W and steps.
  * Mb-SDCA (dual): each node computes independent SDCA deltas for b
    sampled coordinates against the current w_t, scaled by beta / b.

Every node's batch is drawn with the port's threefry ``prng.uniform``, so a
run draws the JAX package's batches from the same seed; the per-node work
is batched over tasks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core import systems_model
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.regularizers import Regularizer, sigma_prime
from repro_torch.utils import prng

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MiniBatchConfig:
    loss: str = "hinge"
    rounds: int = 100
    batch: int = 16          # mini-batch size per node per round
    lr: float = 0.1          # Mb-SGD step size
    beta: float = 4.0        # Mb-SDCA aggregation scaling in [1, batch]
    network: str = "lte"
    seed: int = 0
    record_every: int = 1


@dataclasses.dataclass
class MiniBatchResult:
    W: np.ndarray
    history: Dict[str, List[float]]

    def final(self, key: str) -> float:
        return self.history[key][-1]


def _sample_batch(keys: Tensor, n_t: Tensor, n_max: int,
                  batch: int) -> Tensor:
    """(m, batch) indices drawn uniformly over each node's n_t points."""
    draws = prng.uniform(keys, (batch,))
    idx = (draws * torch.clamp_min(n_t, 1.0)[:, None]).to(torch.int32)
    return torch.clamp_max(idx, n_max - 1).to(torch.int64)


def _gather(a: Tensor, idx: Tensor) -> Tensor:
    """a[t, idx[t, j]] for (m, n) or (m, n, d) a and (m, b) idx."""
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[rows, idx]


# --------------------------------------------------------------------------
# Mb-SGD
# --------------------------------------------------------------------------

def _hinge_subgrad(z, y):
    return torch.where(y * z < 1.0, -y, torch.zeros_like(y))


def _smooth_hinge_subgrad(z, y):
    yz = y * z
    return torch.where(yz >= 1.0, torch.zeros_like(y),
                       torch.where(yz <= 0.5, -y, -y * (1.0 - yz) / 0.5))


_SUBGRADS = {
    "hinge": _hinge_subgrad,
    "smooth_hinge": _smooth_hinge_subgrad,
    "logistic": lambda z, y: -y / (1.0 + torch.exp(y * z)),
    "squared": lambda z, y: z - y,
}


def _sgd_round(loss_name: str, batch: int, data: FederatedData, W: Tensor,
               abar: Tensor, lr: float, key: Tensor) -> Tensor:
    keys = prng.split(key, data.m)
    n_t = data.n_t
    idx = _sample_batch(keys, n_t, data.n_max, batch)
    xb, yb, mb = _gather(data.X, idx), _gather(data.y, idx), _gather(
        data.mask, idx)
    z = torch.einsum("tbd,td->tb", xb, W)
    g = torch.einsum("tb,tbd->td", _SUBGRADS[loss_name](z, yb) * mb, xb)
    grads = g * (n_t / batch)[:, None]      # unbiased for the sum-loss
    grads = grads + 2.0 * abar @ W
    return W - lr * grads


def run_mb_sgd(data: FederatedData, reg: Regularizer, cfg: MiniBatchConfig,
               omega: Optional[Tensor] = None) -> MiniBatchResult:
    """Mb-SGD on ``data``'s device, with step ``lr / sqrt(h + 1)``."""
    loss = get_loss(cfg.loss)
    dev = data.device
    omega = reg.init_omega(data.m, device=dev) if omega is None else omega
    abar = reg.coupling(omega)
    W = torch.zeros((data.m, data.d), dtype=data.X.dtype, device=dev)
    key = prng.PRNGKey(cfg.seed, device=dev)
    net = systems_model.NETWORKS[cfg.network]
    history: Dict[str, List[float]] = {"round": [], "primal": [], "time": []}
    sim_time = 0.0
    steps = np.full((data.m,), cfg.batch)

    for h in range(cfg.rounds):
        key, k = prng.split(key)
        lr_h = float(np.float32(cfg.lr / np.sqrt(h + 1.0)))
        W = _sgd_round(cfg.loss, cfg.batch, data, W, abar, lr_h, k)
        sim_time += systems_model.round_time_sync(
            steps, data.d, net, step_flops=systems_model.SGD_STEP_FLOPS)
        if h % cfg.record_every == 0 or h == cfg.rounds - 1:
            p = dual_mod.primal_objective(data, loss, abar, W)
            history["round"].append(h)
            history["primal"].append(float(p))
            history["time"].append(sim_time)
    return MiniBatchResult(W=W.cpu().numpy(), history=history)


# --------------------------------------------------------------------------
# Mb-SDCA
# --------------------------------------------------------------------------

def _sdca_round(loss: Loss, batch: int, data: FederatedData,
                state: DualState, K: Tensor, q_t: Tensor, beta: float,
                key: Tensor) -> DualState:
    W = dual_mod.primal_weights(K, state.v)
    keys = prng.split(key, data.m)
    idx = _sample_batch(keys, data.n_t, data.n_max, batch)
    xb = _gather(data.X, idx)
    a = _gather(state.alpha, idx)
    xg = torch.einsum("tbd,td->tb", xb, W)
    qxx = q_t[:, None] * torch.sum(xb * xb, dim=-1)
    delta = loss.sdca_delta(a, _gather(data.y, idx), xg, qxx) * _gather(
        data.mask, idx) * (beta / batch)
    dalpha = torch.zeros_like(state.alpha).scatter_add_(1, idx, delta)
    dv = torch.einsum("tb,tbd->td", delta, xb)
    return DualState(alpha=state.alpha + dalpha, v=state.v + dv)


def run_mb_sdca(data: FederatedData, reg: Regularizer, cfg: MiniBatchConfig,
                omega: Optional[Tensor] = None) -> MiniBatchResult:
    """Mb-SDCA on ``data``'s device."""
    loss = get_loss(cfg.loss)
    dev = data.device
    omega = reg.init_omega(data.m, device=dev) if omega is None else omega
    abar = reg.coupling(omega)
    K = torch.linalg.inv(abar)
    q_t = sigma_prime(K) * torch.diagonal(K) / 2.0
    state = dual_mod.init_state(data)
    key = prng.PRNGKey(cfg.seed, device=dev)
    net = systems_model.NETWORKS[cfg.network]
    history: Dict[str, List[float]] = {
        "round": [], "primal": [], "dual": [], "gap": [], "time": []}
    sim_time = 0.0
    steps = np.full((data.m,), cfg.batch)

    for h in range(cfg.rounds):
        key, k = prng.split(key)
        state = _sdca_round(loss, cfg.batch, data, state, K, q_t, cfg.beta,
                            k)
        sim_time += systems_model.round_time_sync(steps, data.d, net)
        if h % cfg.record_every == 0 or h == cfg.rounds - 1:
            W = dual_mod.primal_weights(K, state.v)
            p = dual_mod.primal_objective(data, loss, abar, W)
            dv = dual_mod.dual_objective(data, loss, K, state.alpha, state.v)
            history["round"].append(h)
            history["primal"].append(float(p))
            history["dual"].append(float(dv))
            history["gap"].append(float(p + dv))
            history["time"].append(sim_time)
    W = dual_mod.primal_weights(K, state.v)
    return MiniBatchResult(W=W.cpu().numpy(), history=history)
