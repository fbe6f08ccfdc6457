"""Training loop: ``train_step`` / ``eval_step`` factories.

The port's copy of the JAX package's ``repro.train.loop`` for the dense
family.  The model's parameters are the training state: ``init_train_state``
makes them trainable (and, with ``master_weights``, stores the matrices in
the compute dtype, the optimizer keeping float32 masters), and
``train_step`` writes the optimizer's new values into them in place.  The
forward pass runs the flash attention kernel on the card; its backward
pass recomputes the plain attention (``kernels.flash_attention.ops``), as
the JAX package trains through plain attention under ``jax.checkpoint``.

On a mesh the same step runs on DTensor parameters, optimizer state and
batch (placed by ``launch.sharding``; the attention-block families, inside
``utils.pjit_utils.activation_sharding``): ``param_specs``, the JAX
package's pin of the bf16 weights to their masters' sharding, redistributes
each cast to its master's placements; the gradients come back in their
parameters' placements and the clip's norm is the global one.

What the step keeps between its forward and its backward: the forward
runs with ``train=True``, so with ``ArchConfig.remat`` (every config sets
it) each block's input alone is kept, one (B, S, D) tensor a block (a
period's for zamba2 under ``scan_layers``), and the block is recomputed
in the backward (``pjit_utils.checkpoint``; one more forward of every
block, a flash launch included), as the JAX package's ``jax.checkpoint``;
rwkv6's wkv chunks are recomputed inside it whatever ``remat`` says.  Then
the logits and the loss's own tensors.  Without ``remat`` every block's
activations are kept.  The evaluation step runs with ``train=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.sharding import placements
from repro_torch.models.transformer import Model
from repro_torch.train.losses import next_token_loss
from repro_torch.utils import pjit_utils as pj
from repro_torch.train.optimizer import (AdamW, AdamWState, global_norm,
                                         tree_leaves, tree_map)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    compute_dtype: torch.dtype = torch.float32   # or torch.bfloat16
    master_weights: bool = False      # bf16 params + f32 masters in optimizer


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(lr=tc.lr, b1=tc.b1, b2=tc.b2,
                 weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
                 master_weights=tc.master_weights)


def _cast_weights(params, dtype: torch.dtype, param_specs: Any = None):
    """Matrices still in float32 cast to the compute dtype at step entry
    (differentiably: the gradient lands on the float32 leaf); float32
    masters stay in the optimizer (classic mixed precision).  With
    ``param_specs`` (the plan's spec tree of ``params``) a cast DTensor is
    redistributed to its spec's placements, its master's: a no-op where
    the cast kept them, so the FSDP gathers move the compute dtype."""
    if dtype == torch.float32:
        return params

    def one(p, spec):
        if not (p.dim() >= 2 and p.dtype == torch.float32):
            return p
        c = p.to(dtype)
        if spec is not None and pj.on_mesh(c):
            c = c.redistribute(c.device_mesh, placements(
                spec, pj.mesh_spec(c.device_mesh)))
        return c

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, None if s is None else s[k])
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, None if s is None else s[i])
                    for i, v in enumerate(t)]
        return one(t, s)

    return walk(params, param_specs)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, Tensor]:
    """The batch as tensors on ``device``; DTensors (a batch placed on a
    mesh) stay where they are."""
    return {k: v if pj.on_mesh(v) else
            (v if torch.is_tensor(v)
             else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _full(x: Tensor) -> Tensor:
    """A metric as a plain tensor (a DTensor's whole value)."""
    return x.full_tensor() if pj.on_mesh(x) else x


def make_grad_fn(model: Model, tc: TrainConfig, param_specs: Any = None
                 ) -> Callable[..., Tuple[Any, Dict[str, Tensor]]]:
    """Returns grad_fn(params, batch) -> (grads, metrics): the gradients of
    the next-token loss with respect to ``params`` (a tree of the model's
    layout; on a mesh, each in its parameter's placements) and the metrics
    ``ce``, ``loss`` and ``grad_norm`` (plain tensors).  ``param_specs`` as
    ``make_train_step``'s."""
    cfg = model.cfg

    def grad_fn(params, batch):
        batch = _on_device(batch, model.device)
        logits, aux = model.forward(
            _cast_weights(params, tc.compute_dtype, param_specs), batch,
            dtype=tc.compute_dtype, train=True)
        loss, metrics = next_token_loss(cfg, logits, batch, aux)
        leaves = tree_leaves(params)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda p: by_id[id(p)], params)
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                     p.placements)
                         if pj.on_mesh(g) else g, grads, params)
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = _full(global_norm(grads))
        return grads, metrics

    return grad_fn


def make_train_step(model: Model, tc: TrainConfig, param_specs: Any = None
                    ) -> Callable[..., Tuple[Any, AdamWState, Dict]]:
    """Returns train_step(params, opt_state, batch) -> (params, opt',
    metrics): one AdamW step.  ``params`` is ``model.tree()`` after
    ``init_train_state``; the optimizer writes the new values into those
    tensors (and its state) in place and the same tree is returned.

    param_specs: the plan's spec tree of ``params``
    (``launch.sharding.params_shardings``), for a step on a mesh: each
    float32 matrix's cast to the compute dtype is pinned to its master's
    placements, as the JAX package pins it."""
    opt = make_optimizer(tc)
    grad_fn = make_grad_fn(model, tc, param_specs)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model, tc: TrainConfig):
    cfg = model.cfg

    @torch.no_grad()
    def eval_step(params, batch):
        batch = _on_device(batch, model.device)
        logits, aux = model.forward(params, batch, dtype=tc.compute_dtype,
                                    train=False)
        _, metrics = next_token_loss(cfg, logits, batch, aux)
        return metrics

    return eval_step


def make_trainable(model: Model, tc: TrainConfig):
    """``model``'s parameters made trainable, with ``master_weights`` the
    matrices stored in ``tc.compute_dtype`` first; returns the tree.  On a
    mesh, call it before the parameters are placed (``sharding.
    distribute``): a DTensor's ``data`` cannot change its dtype."""
    for p in model.parameters():
        if tc.master_weights and p.dim() >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(tc.compute_dtype)
        p.requires_grad_(True)
    return model.tree()


def init_train_state(model: Model, tc: TrainConfig):
    """(params, opt_state) for training ``model`` from its current weights:
    ``make_trainable``, then the optimizer's state of those parameters (the
    masters are their values in float32, as the JAX package's ``init``
    makes them; on a mesh each leaf in its parameter's placements)."""
    params = make_trainable(model, tc)
    return params, make_optimizer(tc).init(params)
