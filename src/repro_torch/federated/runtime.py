"""Distributed MOCHA federated round over ``torch.distributed``.

Communication pattern (the paper's Section 3.3 on a process group):

  * alpha, X, y, mask, budgets, keys: sharded over the ``data`` mesh axis;
                                 rank r solves the contiguous block of
                                 tasks [r b, (r + 1) b), b = m_pad / k
  * v = X alpha (m, d):          replicated; the round's update Delta v is
                                 produced block by block and exchanged with
                                 ONE all-gather over ``data`` -- the paper's
                                 "only v_t must be communicated"
  * K rows:                      each rank reads the rows of K = Abar^{-1}
                                 of its own tasks (w_t = 1/2 K_t: V needs
                                 all of v but only the local rows of K)

The solve of a rank's block is the local engine's ``batched_local_sdca``,
so on one rank a round gives the local engine's bits; on k ranks a block's
W rows are a product of another shape and agree to float32 rounding.

Every rank runs the whole program (SPMD): the driver, the Omega step and
the simulated clock are replicated and draw the same numbers on every rank,
and only the round's Delta v crosses ranks.  Files a run writes are written
by rank 0 alone (``utils.dist.writes_files``).
"""
from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.dual import FederatedData
from repro_torch.core.losses import Loss
from repro_torch.core.subproblem import batched_local_sdca, row_norms
from repro_torch.utils.device import resolve_device

Tensor = torch.Tensor

#: the mesh axis the tasks are sharded over
AXIS = "data"
#: how long a rank waits in a collective for the others
TIMEOUT = timedelta(seconds=300)


def check_group(group, device: torch.device) -> None:
    """Raise unless ``group`` carries tensors of ``device``'s type: a CPU
    federation under an NCCL group, or a CUDA one under a group with no
    CUDA backend, is refused rather than moved.  A group's backends read
    as "cpu:gloo,cuda:nccl"."""
    config = dist.get_backend_config(group)
    if device.type not in dict(p.split(":") for p in config.split(",")):
        raise RuntimeError(
            f"a {device.type} federation cannot run under a process group "
            f"with backends {config!r}; initialize the group with a "
            f"{device.type} backend (gloo on the CPU, nccl on the card)")


def init_default_group(timeout: timedelta = TIMEOUT) -> None:
    """The process group of a run that found none: the launcher's ranks
    (``torchrun`` sets WORLD_SIZE; each rank has chosen its card), else
    one rank on a ``HashStore``.  Both carry CPU tensors through gloo and,
    where there is a card, CUDA tensors through NCCL; a rank waits
    ``timeout`` in a collective for the others.  The one-rank group is
    this module's own, so it is destroyed at exit; a launcher's group
    stays its caller's to destroy."""
    backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
               else "gloo")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        atexit.register(_destroy_own_group, dist.group.WORLD)


def _destroy_own_group(group) -> None:
    """Destroy ``group`` at exit if it is still the default group: a caller
    that destroyed it first, or replaced it, keeps what it did."""
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


def make_federated_mesh(n_shards: Optional[int] = None, device=None):
    """1-D ``DeviceMesh`` over the ``data`` axis: every rank of the default
    process group, on ``device``'s type (the card unless the caller asks
    for the CPU).  Where no group exists one is made, once per process.
    ``n_shards`` must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_default_group()
    world = dist.get_world_size()
    if n_shards is not None and n_shards != world:
        raise ValueError(
            f"n_shards={n_shards} but the process group has {world} ranks; "
            "a federated mesh spans every rank")
    check_group(dist.group.WORLD, dev)
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))


def check_mesh(mesh, device: torch.device):
    """``mesh`` if it is a 1-D mesh whose group carries ``device``'s
    tensors; raises otherwise."""
    if mesh.ndim != 1:
        raise ValueError(f"the federated mesh is 1-D, got {mesh.ndim} dims")
    if mesh.device_type != device.type:
        raise RuntimeError(
            f"a {device.type} federation cannot run on a "
            f"{mesh.device_type} mesh")
    check_group(mesh.get_group(), device)
    return mesh


def shard_bounds(mesh, m_pad: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of the padded tasks."""
    k = mesh.size()
    if m_pad % k:
        raise ValueError(f"{m_pad} tasks do not split over {k} ranks; "
                         "pad them first (sharding.pad_tasks)")
    block = m_pad // k
    rank = mesh.get_local_rank()
    return rank * block, (rank + 1) * block


def all_gather_rows(mesh, block: Tensor) -> Tensor:
    """Every rank's ``block`` stacked along axis 0 in rank order: one
    all-gather over the mesh's group."""
    out = block.new_empty((mesh.size() * block.shape[0],)
                          + tuple(block.shape[1:]))
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:   # torch before all_gather_single
        gather = dist.all_gather_into_tensor
    gather(out, block.contiguous(), group=mesh.get_group())
    return out


def wire_dtype(comm_dtype) -> Optional[torch.dtype]:
    """The Delta v wire's dtype: None (v's own), a ``torch.dtype``, or its
    name ("bfloat16")."""
    if comm_dtype is None or isinstance(comm_dtype, torch.dtype):
        return comm_dtype
    dt = getattr(torch, str(comm_dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"comm_dtype {comm_dtype!r} is not a torch dtype")
    return dt


def distributed_round(mesh, loss: Loss, max_steps: int, data: FederatedData,
                      alpha: Tensor, v: Tensor, K: Tensor, q_t: Tensor,
                      budgets: Tensor, gamma: float, keys: Tensor,
                      comm_dtype=None, gram=None) -> Tuple[Tensor, Tensor]:
    """One federated W-round, tasks sharded over the mesh's ``data`` axis.

    Args:
      data/alpha/q_t/budgets/keys: task-major, m divisible by the rank
        count; each rank reads its own block.
      v: the replicated (m, d) communicated state.
      K: (m, m); a rank reads its block's rows, every column.
      comm_dtype: optional wire dtype for the Delta v exchange (bf16
        halves the round's only communicated tensor; it is cast back
        before it is added, so the replicated v accumulates in v's dtype).
      gram: the residual-mode override (``MochaConfig.gram_max_d``
        resolved by the driver); None keeps the solver's default.
    Returns (alpha_block, v'): this rank's block of alpha, and the
    replicated v.  The round's one collective is the Delta v all-gather.
    """
    xnorm2 = data.xnorm2 if data.xnorm2 is not None else row_norms(data.X)
    lo, hi = shard_bounds(mesh, data.m)
    sh = slice(lo, hi)
    # local W rows for this block's tasks: w_t = 1/2 sum_s K_ts v_s
    W_sh = 0.5 * K[sh] @ v
    dalpha, u = batched_local_sdca(
        loss, data.X[sh], data.y[sh], data.mask[sh], alpha[sh], W_sh,
        q_t[sh], budgets[sh], keys[sh], max_steps, xnorm2=xnorm2[sh],
        gram=gram)
    # THE federated communication: exchange the Delta v blocks
    wire = wire_dtype(comm_dtype)
    du = all_gather_rows(mesh, u if wire is None else u.to(wire))
    return alpha[sh] + gamma * dalpha, v + gamma * du.to(v.dtype)

