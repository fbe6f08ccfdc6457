"""Optimizers: AdamW, SGD with momentum, global-norm clipping, schedules.

The port's copy of the JAX package's ``repro.train.optimizer``, with its
update arithmetic: clip first (the clipped gradients in float32), then the
moments, the bias corrections ``1 - b ** step`` in float32, and the
decoupled decay ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``.
``torch.optim`` is not used: its update is arranged otherwise.

Parameter trees are the model's layout (nested dicts and lists of
tensors); optimizer state is a tree of the same shape.  ``update`` works in
place: the JAX package's arithmetic, op for op, with each result written
into the parameters and the state's trees (so a model's tensors are the
only copy of its parameters), and the same trees returned with the new
state.  The step count and the learning rate live on the host (a Python
int and a float32 value), so an update reads nothing back from the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor
Params = Any
Schedule = Callable[[int], float]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Tensor]:
    """The leaves, dicts in sorted key order (``jax.tree_util``'s order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _f32(x: float) -> float:
    """``x`` rounded to float32 (what a float32 scalar holds)."""
    return float(np.float32(x))


class AdamWState(NamedTuple):
    step: int
    mu: Params
    nu: Params
    master: Optional[Params] = None  # f32 masters when params live in bf16


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with optional f32 master weights.

    ``master_weights=True`` is the mixed-precision mode: the parameters
    themselves are bf16 (the forward and backward passes read 2-byte
    weights), while the optimizer carries the f32 masters, applies the
    update there, and hands back the masters cast to the parameters' dtype.
    """

    lr: Union[float, Schedule] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master_weights: bool = False

    @torch.no_grad()
    def init(self, params: Params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        master = (tree_map(lambda p: p.float().clone(), params)
                  if self.master_weights else None)
        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params), master=master)

    def _lr(self, step: int) -> float:
        return _f32(self.lr(step) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params):
        """One step, in place: ``params`` and the trees of ``state`` take
        the new values; returns ``(params, state')``."""
        step = state.step + 1
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(step))
        lr = self._lr(step)
        anchor = state.master if self.master_weights else params
        for p, a, m, v, g in zip(tree_leaves(params), tree_leaves(anchor),
                                 tree_leaves(state.mu),
                                 tree_leaves(state.nu), tree_leaves(grads)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            a.sub_(lr * ((m / bc1) / ((v / bc2).sqrt() + self.eps)
                         + self.weight_decay * a))
            if a is not p:
                p.copy_(a)
        return params, state._replace(step=step)


class SGDState(NamedTuple):
    step: int
    momentum: Params


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Union[float, Schedule] = 1e-2
    momentum: float = 0.9
    clip_norm: Optional[float] = None

    def init(self, params: Params) -> SGDState:
        return SGDState(step=0, momentum=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Params, state: SGDState, params: Params):
        """One step, in place, as ``AdamW.update``."""
        step = state.step + 1
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        lr = _f32(self.lr(step) if callable(self.lr) else self.lr)
        for p, m, g in zip(tree_leaves(params), tree_leaves(state.momentum),
                           tree_leaves(grads)):
            m.mul_(self.momentum).add_(g)
            p.sub_(lr * m)
        return params, state._replace(step=step)


def global_norm(tree: Params) -> Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares.
    Over DTensor leaves, the norm of the whole tensors (``_mesh_norm``)."""
    with torch.no_grad():
        leaves = tree_leaves(tree)
        if leaves and _on_mesh(leaves[0]):
            return _mesh_norm(leaves)
        return torch.sqrt(sum(torch.sum(x.float().square())
                              for x in leaves))


def _on_mesh(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_norm(leaves: List[Tensor]) -> Tensor:
    """The global norm of DTensor leaves on one mesh, with one reduction:
    each rank sums the squares of its shard of each leaf where it is the
    first of the ranks that hold that shard (coordinate 0 on the mesh dims
    the leaf is replicated over), and the ranks' sums are added.  A
    replicated scalar DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        if any(p.is_partial() for p in x.placements):
            x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in x.placements])
        if all(coord[i] == 0 for i, p in enumerate(x.placements)
               if isinstance(p, Replicate)):
            total = total + torch.sum(x.to_local().float().square())
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * mesh.ndim))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale every leaf by min(1, max_norm / max(norm, 1e-9)), in float32
    (a bf16 leaf comes back float32, as the JAX package's promotion
    gives)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Schedule:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; step -> learning rate,
    computed in float32 as the JAX package computes it."""
    f = np.float32

    def fn(step) -> float:
        s = f(step)
        if s < warmup:
            return float(f(base_lr) * s / f(max(1, warmup)))
        prog = np.clip((s - f(warmup)) / f(max(1, total - warmup)),
                       f(0.0), f(1.0))
        return float(f(base_lr) * (f(min_frac) + f(1 - min_frac) * f(0.5)
                                   * (f(1) + np.cos(f(math.pi) * prog))))

    return fn
