"""Carry a JAX run's data and state into the port, as numpy arrays.

A federation, a mid-run dual state (alpha, v) and a relationship matrix
Omega exported from the JAX package with ``np.asarray`` become the port's
containers on the requested device; a port run then continues from them
through ``Exec(state0=...)`` and ``Method(omega0=...)``::

    data = federation_from_numpy(X, y, mask, device="cuda")
    state = state_from_numpy(res.state.alpha, res.state.v, device="cuda")
    omega = omega_from_numpy(res.omega, device="cuda")

Arrays are copied as float32; the device is the card unless asked.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.dual import DualState, FederatedData
from repro_torch.utils.device import resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def federation_from_numpy(X, y, mask, xnorm2=None,
                          device: Optional[str] = None) -> FederatedData:
    """``FederatedData`` from (m, n, d) X and (m, n) y, mask, xnorm2."""
    dev = resolve_device(device)
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
