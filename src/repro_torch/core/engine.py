"""RoundEngine: pluggable executors for MOCHA's federated W-round.

The outer loop of Algorithm 1 (Omega refreshes, budgets, the simulated
clock, metrics) does not depend on how one round of local solves runs;
an engine maps that round onto an execution substrate:

  * ``LocalEngine``  -- the plain PyTorch SDCA solver
                        (``subproblem.batched_local_sdca``), every loss;
  * ``KernelEngine`` -- the Hopper SDCA kernel (``repro_torch.kernels.sdca``),
                        hinge loss only; the counterpart of the JAX
                        package's ``PallasEngine``.

Contract: ``setup(data, loss, max_steps, gram=None)`` returns the initial
``DualState``; ``round(state, K, q_t, budgets, gamma, key)`` returns the
updated one.  Every engine splits ``key`` into per-task keys with
``prng.split(key, m)``, so engines (and the JAX package's engines) draw the
same coordinate streams from the same key.

An engine with ``supports_scan`` also hands the pre-sampled driver a pure
round function (``scan_round_fn``) that reads nothing back to the host, so
that a CUDA graph can capture it.  The kernel engine keeps the loop driver,
as the JAX package's ``PallasEngine`` does.
"""
from __future__ import annotations

import abc
from typing import Optional

import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.losses import Loss
from repro_torch.core.subproblem import batched_local_sdca
from repro_torch.utils import prng

Tensor = torch.Tensor


class RoundEngine(abc.ABC):
    """Executes one federated W-update round for the MOCHA driver."""

    name: str = "abstract"
    #: True iff the pre-sampled driver may run this engine's rounds
    #: (``scan_round_fn``); engines with host-side work keep the loop
    supports_scan: bool = False

    def scan_round_fn(self):
        """Pure round function for the pre-sampled driver, called as
        ``fn(loss, max_steps, gram, data, state, K, q_t, budgets, gamma,
        key)``: no host read, bits equal to ``round``."""
        raise NotImplementedError(
            f"engine {self.name!r} does not support the scanned driver")

    @abc.abstractmethod
    def setup(self, data: FederatedData, loss: Loss, max_steps: int,
              gram: Optional[bool] = None) -> DualState:
        """Bind the engine to a problem; return the initial dual state."""

    @abc.abstractmethod
    def round(self, state: DualState, K: Tensor, q_t: Tensor,
              budgets: Tensor, gamma: float, key: Tensor) -> DualState:
        """One round: every node solves its local subproblem, server
        reduces."""


def _apply(state: DualState, gamma: float, dalpha: Tensor,
           u: Tensor) -> DualState:
    return DualState(alpha=state.alpha + gamma * dalpha,
                     v=state.v + gamma * u)


def _local_round(loss: Loss, max_steps: int, gram: Optional[bool],
                 data: FederatedData, state: DualState, K: Tensor,
                 q_t: Tensor, budgets: Tensor, gamma: float, key: Tensor,
                 static: bool = False) -> DualState:
    """One round of the plain solver.  ``K`` (m, m) and ``key`` (2,) are
    one federation's; given (C, m, m) and (C, 2), ``data`` and ``state``
    hold C federations of m tasks each along their task axis (C*m tasks,
    the sweep's cells), solved as one batch."""
    W = dual_mod.primal_weights(
        K, state.v.reshape(*K.shape[:-1], -1)).reshape(state.v.shape)
    keys = prng.split(key, K.shape[-1]).reshape(-1, 2)
    dalpha, u = batched_local_sdca(
        loss, data.X, data.y, data.mask, state.alpha, W, q_t, budgets, keys,
        max_steps, xnorm2=data.xnorm2, gram=gram, static=static)
    return _apply(state, gamma, dalpha, u)


def _scan_local_round(loss, max_steps, gram, data, state, K, q_t, budgets,
                      gamma, key) -> DualState:
    """``_local_round`` over every chunk: no host read."""
    return _local_round(loss, max_steps, gram, data, state, K, q_t, budgets,
                        gamma, key, static=True)


class LocalEngine(RoundEngine):
    """The plain PyTorch solver, batched over tasks: every loss."""

    name = "local"
    supports_scan = True

    def setup(self, data, loss, max_steps, gram=None):
        self.data, self.loss, self.max_steps = data, loss, max_steps
        self.gram = gram
        return dual_mod.init_state(data)

    def round(self, state, K, q_t, budgets, gamma, key):
        return _local_round(self.loss, self.max_steps, self.gram, self.data,
                            state, K, q_t, budgets, gamma, key)

    def scan_round_fn(self):
        return _scan_local_round


class KernelEngine(RoundEngine):
    """The Hopper SDCA kernel (hinge loss), one launch per round.

    On a CPU federation the kernel's wrapper runs its plain version, which
    is how the CPU tests drive this engine."""

    name = "kernel"

    def setup(self, data, loss, max_steps, gram=None):
        if loss.name != "hinge":
            raise ValueError(
                f"KernelEngine implements the hinge kernel only, got "
                f"{loss.name!r}; use engine='local' for other losses.")
        self.data, self.max_steps, self.gram = data, max_steps, gram
        return dual_mod.init_state(data)

    def round(self, state, K, q_t, budgets, gamma, key):
        from repro_torch.kernels.sdca.ops import kernel_local_sdca
        W = dual_mod.primal_weights(K, state.v)
        keys = prng.split(key, self.data.m)
        dalpha, u = kernel_local_sdca(self.data, state.alpha, W, q_t,
                                      budgets, keys, self.max_steps,
                                      gram=self.gram)
        return _apply(state, gamma, dalpha, u)


ENGINES = {"local": LocalEngine, "kernel": KernelEngine}

#: engines of the JAX package that the port does not have yet
_LATER = {"sharded": "ROADMAP.md Queue 1 item 13 (sharded runtime)",
          "pallas": "its counterpart here is engine='kernel'"}


def get_engine(spec=None) -> RoundEngine:
    """Resolve an engine spec: None | name | class | instance."""
    if spec is None:
        return LocalEngine()
    if isinstance(spec, RoundEngine):
        return spec
    if isinstance(spec, str):
        if spec in _LATER:
            raise NotImplementedError(
                f"engine {spec!r} is not in the port: {_LATER[spec]}")
        if spec not in ENGINES:
            raise KeyError(
                f"unknown engine {spec!r}; available: {sorted(ENGINES)}")
        return ENGINES[spec]()
    if isinstance(spec, type) and issubclass(spec, RoundEngine):
        return spec()
    raise TypeError(f"cannot resolve engine from {spec!r}")
