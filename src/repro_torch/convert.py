"""Carry a JAX run's data and state into the port, as numpy arrays.

A federation, a mid-run dual state (alpha, v) and a relationship matrix
Omega exported from the JAX package with ``np.asarray`` become the port's
containers on the requested device; a port run then continues from them
through ``Exec(state0=...)`` and ``Method(omega0=...)``::

    data = federation_from_numpy(X, y, mask, device="cuda")
    shuffles = federation_from_numpy(Xs, ys, masks, device="cuda")  # stacked
    state = state_from_numpy(res.state.alpha, res.state.v, device="cuda")
    omega = omega_from_numpy(res.omega, device="cuda")

A JAX language model's parameter tree becomes the port's ``Model``::

    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, device="cuda")

Arrays are copied as float32; the device is the card unless asked.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dual import DualState, FederatedData
from repro_torch.utils.device import resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def federation_from_numpy(X, y, mask, xnorm2=None,
                          device: Optional[str] = None) -> FederatedData:
    """``FederatedData`` from (m, n, d) X and (m, n) y, mask, xnorm2, or
    from a stack of shuffles: (S, m, n, d) X and (S, m, n) y, mask, xnorm2
    (the JAX package's ``stack_federations`` layout)."""
    dev = resolve_device(device)
    X = np.asarray(X)
    if X.ndim not in (3, 4):
        raise ValueError(f"X must be (m, n, d) or (S, m, n, d), got "
                         f"{X.shape}")
    for name, a in (("y", y), ("mask", mask), ("xnorm2", xnorm2)):
        if a is not None and np.shape(a) != X.shape[:-1]:
            raise ValueError(f"{name} must be {X.shape[:-1]}, got "
                             f"{np.shape(a)}")
    return FederatedData(X=_tensor(X, dev), y=_tensor(y, dev),
                         mask=_tensor(mask, dev),
                         xnorm2=None if xnorm2 is None else _tensor(xnorm2,
                                                                    dev))


def state_from_numpy(alpha, v, device: Optional[str] = None) -> DualState:
    """``DualState`` from (m, n) alpha and (m, d) v = X alpha."""
    dev = resolve_device(device)
    return DualState(alpha=_tensor(alpha, dev), v=_tensor(v, dev))


def omega_from_numpy(omega, device: Optional[str] = None) -> torch.Tensor:
    """The (m, m) relationship matrix Omega."""
    return _tensor(omega, resolve_device(device))


def lm_params_from_numpy(tree: Mapping[str, Any], cfg,
                         device: Optional[str] = None):
    """The port's ``Model`` of ``cfg`` holding the JAX parameter tree
    ``tree`` (numpy leaves), of any family: attention (dense, MoE, vlm,
    audio), rwkv6 or the mamba2 hybrid with its ``shared`` block and
    ``shared_proj``.  Blocks may be a list of per-layer trees
    (``reduced()``) or stacked (``scan_layers=True``): on a leading layer
    axis, or for the hybrid on (n_periods, period) axes with the leftover
    layers stacked in ``tail_blocks``."""
    from repro_torch.models.transformer import Model
    model = Model(cfg, device=resolve_device(device), seed=None)
    tree = dict(tree)
    blocks = tree["blocks"]
    tail = tree.pop("tail_blocks", None)
    if isinstance(blocks, Mapping):    # stacked: take layer i of each leaf
        if cfg.shared_attn_period:
            period = cfg.shared_attn_period
            n_periods = cfg.n_layers // period
            blocks = [_layer(_layer(blocks, i), j)
                      for i in range(n_periods) for j in range(period)]
            if tail is not None:
                blocks += [_layer(tail, j) for j in range(
                    cfg.n_layers - n_periods * period)]
        else:
            blocks = [_layer(blocks, i) for i in range(cfg.n_layers)]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
    _copy_into(model.tree(), dict(tree, blocks=list(blocks)), "params")
    return model


def _layer(tree, i):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


@torch.no_grad()
def _copy_into(dst, src, path: str) -> None:
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{path}: keys {sorted(src)}, expected "
                             f"{sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{path}.{k}")
    elif isinstance(dst, list):
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{path}[{i}]")
    else:
        a = np.array(src, dtype=np.float32)   # writable, for torch
        if a.shape != tuple(dst.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))
