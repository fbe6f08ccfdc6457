"""RoundEngine: pluggable executors for MOCHA's federated W-round.

The outer loop of Algorithm 1 (Omega refreshes, budgets, the simulated
clock, metrics) does not depend on how one round of local solves runs;
an engine maps that round onto an execution substrate:

  * ``LocalEngine``  -- the plain PyTorch SDCA solver
                        (``subproblem.batched_local_sdca``), every loss;
  * ``KernelEngine`` -- the Hopper SDCA kernel (``repro_torch.kernels.sdca``),
                        hinge loss only; the counterpart of the JAX
                        package's ``PallasEngine``;
  * ``ShardedEngine`` -- the sharded runtime (``repro_torch.federated``):
                        tasks sharded over the ranks of a process group,
                        Delta v exchanged with one all-gather a round (the
                        paper's only communication).

Contract: ``setup(data, loss, max_steps, gram=None)`` returns the initial
``DualState``; ``round(state, K, q_t, budgets, gamma, key)`` returns the
updated one.  Every engine splits ``key`` into per-task keys with
``prng.split(key, m)``, so engines (and the JAX package's engines) draw the
same coordinate streams from the same key.

An engine with ``supports_scan`` also hands the pre-sampled driver a pure
round function (``scan_round_fn``) that reads nothing back to the host, so
that a CUDA graph can capture it.  The kernel and sharded engines keep the
loop driver, as the JAX package's ``PallasEngine`` and ``ShardedEngine``
do.
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


class ShardedEngine(RoundEngine):
    """The sharded runtime: tasks sharded over the mesh's ``data`` axis.

    Data, alpha, budgets and keys are read block by block, v is replicated,
    and the round's Delta v exchange is one all-gather.  The task axis is
    padded to a multiple of the rank count with empty tasks (mask 0,
    budget 0), which receive exactly zero updates; the driver only sees
    real-size state, so the engine gathers the alpha blocks back for it (a
    second all-gather, of alpha's f32 rows).  ``mesh`` defaults to every
    rank of the process group (``make_federated_mesh``); ``comm_dtype``
    optionally narrows the wire (``torch.bfloat16`` or ``"bfloat16"``)."""

    name = "sharded"

    def __init__(self, mesh=None, comm_dtype=None):
        from repro_torch.federated.runtime import wire_dtype
        self._mesh_arg = mesh
        self.comm_dtype = wire_dtype(comm_dtype)

    def setup(self, data, loss, max_steps, gram=None):
        from repro_torch.federated import runtime, sharding
        self.mesh = (runtime.make_federated_mesh(device=data.device)
                     if self._mesh_arg is None
                     else runtime.check_mesh(self._mesh_arg, data.device))
        self.loss, self.max_steps, self.gram = loss, max_steps, gram
        self.data_p, _ = sharding.pad_tasks(data, self.mesh.size())
        self.m_real, self.m_pad = data.m, self.data_p.m
        self._K_src = self._q_src = None
        return dual_mod.init_state(data)

    def _padded_coupling(self, K: Tensor, q_t: Tensor):
        # K and q_t change only on an Omega refresh: cache the O(m^2) pad
        # by identity instead of padding again every round
        from repro_torch.federated import sharding
        if self._K_src is not K:
            self._K_src = K
            self._K_p = sharding.pad_task_matrix(K, self.m_pad)
        if self._q_src is not q_t:
            self._q_src = q_t
            self._q_p = sharding.pad_vector(q_t, self.m_pad, fill=1.0)
        return self._K_p, self._q_p

    def _pad_keys(self, key: Tensor) -> Tensor:
        # split for the REAL tasks (the other engines' keys), pad with
        # zeros: padded tasks have budget 0 and mask 0, so never draw
        from repro_torch.federated import sharding
        return sharding.pad_vector(prng.split(key, self.m_real), self.m_pad)

    def round(self, state, K, q_t, budgets, gamma, key):
        from repro_torch.federated import runtime, sharding
        m_pad = self.m_pad
        K_p, q_p = self._padded_coupling(K, q_t)
        alpha_sh, v = runtime.distributed_round(
            self.mesh, self.loss, self.max_steps, self.data_p,
            sharding.pad_vector(state.alpha, m_pad),
            sharding.pad_vector(state.v, m_pad), K_p, q_p,
            sharding.pad_vector(budgets.to(torch.int32), m_pad), gamma,
            self._pad_keys(key), comm_dtype=self.comm_dtype, gram=self.gram)
        alpha = runtime.all_gather_rows(self.mesh, alpha_sh)
        return DualState(alpha=alpha[:self.m_real], v=v[:self.m_real])


ENGINES = {"local": LocalEngine, "kernel": KernelEngine,
           "sharded": ShardedEngine}

#: engines of the JAX package that the port names otherwise
_LATER = {"pallas": "its counterpart here is engine='kernel'"}


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
