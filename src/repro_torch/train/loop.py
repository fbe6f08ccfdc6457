"""Training loop: ``train_step`` / ``eval_step`` factories.

The port's copy of the JAX package's ``repro.train.loop`` for the dense
family.  The model's parameters are the training state: ``init_train_state``
makes them trainable (and, with ``master_weights``, stores the matrices in
the compute dtype, the optimizer keeping float32 masters), and
``train_step`` writes the optimizer's new values into them in place.  The
forward pass runs the flash attention kernel on the card; its backward
pass recomputes the plain attention (``kernels.flash_attention.ops``), as
the JAX package trains through plain attention under ``jax.checkpoint``.

The JAX package's ``param_specs`` (the pjit pin of the bf16 weights to
their masters' sharding) has no counterpart until the port runs its step
on a mesh (ROADMAP.md item 22; the plan is ``launch.sharding``);
``ArchConfig.remat`` is not read
(activations are kept, one layer's attention scores are recomputed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.train.losses import next_token_loss
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


def _cast_weights(params, dtype: torch.dtype):
    """Matrices still in float32 cast to the compute dtype at step entry
    (differentiably: the gradient lands on the float32 leaf); float32
    masters stay in the optimizer (classic mixed precision)."""
    if dtype == torch.float32:
        return params
    return tree_map(lambda p: p.to(dtype)
                    if p.dim() >= 2 and p.dtype == torch.float32 else p,
                    params)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, Tensor]:
    return {k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def make_grad_fn(model: Model, tc: TrainConfig
                 ) -> Callable[..., Tuple[Any, Dict[str, Tensor]]]:
    """Returns grad_fn(params, batch) -> (grads, metrics): the gradients of
    the next-token loss with respect to ``params`` (a tree of the model's
    layout) and the metrics ``ce``, ``loss`` and ``grad_norm``."""
    cfg = model.cfg

    def grad_fn(params, batch):
        batch = _on_device(batch, model.device)
        logits, aux = model.forward(_cast_weights(params, tc.compute_dtype),
                                    batch, dtype=tc.compute_dtype)
        loss, metrics = next_token_loss(cfg, logits, batch, aux)
        leaves = tree_leaves(params)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda p: by_id[id(p)], params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        return grads, metrics

    return grad_fn


def make_train_step(model: Model, tc: TrainConfig
                    ) -> Callable[..., Tuple[Any, AdamWState, Dict]]:
    """Returns train_step(params, opt_state, batch) -> (params, opt',
    metrics): one AdamW step.  ``params`` is ``model.tree()`` after
    ``init_train_state``; the optimizer writes the new values into those
    tensors (and its state) in place and the same tree is returned."""
    opt = make_optimizer(tc)
    grad_fn = make_grad_fn(model, tc)

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
        logits, aux = model.forward(params, batch, dtype=tc.compute_dtype)
        _, metrics = next_token_loss(cfg, logits, batch, aux)
        return metrics

    return eval_step


def init_train_state(model: Model, tc: TrainConfig):
    """(params, opt_state) for training ``model`` from its current weights:
    the parameters made trainable, with ``master_weights`` the matrices
    stored in ``tc.compute_dtype`` first (the masters are those values in
    float32, as the JAX package's ``init`` makes them)."""
    for p in model.parameters():
        if tc.master_weights and p.dim() >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(tc.compute_dtype)
        p.requires_grad_(True)
    params = model.tree()
    return params, make_optimizer(tc).init(params)
