"""Task sharding for the federated MTL runtime.

MOCHA's m federated nodes map onto the ranks of the ``data`` mesh axis: each
rank owns a contiguous block of tasks and runs their local dual solves. The
task count is padded to a multiple of the rank count with empty (mask = 0)
tasks, which the solver never touches (budget 0 and n_t = 0).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.dual import FederatedData

Tensor = torch.Tensor


def pad_tasks(data: FederatedData, shards: int) -> Tuple[FederatedData, int]:
    """Pad the task axis to a multiple of ``shards``.  Returns (data, m),
    m the real task count; ``xnorm2`` pads beside X."""
    m = data.m
    m_pad = ((m + shards - 1) // shards) * shards
    if m_pad == m:
        return data, m
    extra = m_pad - m

    def pad(a):
        return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])

    return FederatedData(
        X=pad(data.X), y=pad(data.y), mask=pad(data.mask),
        xnorm2=None if data.xnorm2 is None else pad(data.xnorm2)), m


def pad_task_matrix(K: Tensor, m_pad: int) -> Tensor:
    """Embed the m x m coupling inverse into m_pad x m_pad.

    Padding tasks get an identity diagonal (any SPD value works: their alpha
    and v stay exactly zero, so their entries of K multiply zeros).
    """
    m = K.shape[0]
    if m_pad == m:
        return K
    out = torch.eye(m_pad, dtype=K.dtype, device=K.device)
    out[:m, :m] = K
    return out


def pad_vector(x: Tensor, m_pad: int, fill: float = 0.0) -> Tensor:
    """Pad the leading (task) axis of ``x`` to ``m_pad`` with ``fill``."""
    m = x.shape[0]
    if m_pad == m:
        return x
    return torch.cat([x, x.new_full((m_pad - m,) + tuple(x.shape[1:]),
                                    fill)])
