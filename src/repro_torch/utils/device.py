"""Device resolution: the card by default, the CPU (or ``meta``) only when
asked."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``"cuda"``.  Raises when CUDA is asked for (or defaulted
    to) and absent: a run never moves to the CPU unless the caller said so.
    ``"meta"`` (never a default) gives tensors with shapes and dtypes and no
    storage: the abstract trees of ``launch.specs``, as ``jax.eval_shape``
    gives the JAX package's.
    On the card, float32 matrix products are held to full float32 (TF32
    off), which the port's parity tolerances assume.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         f"'meta'")
    return dev
