"""Device resolution: the card by default, the CPU only when asked."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``"cuda"``.  Raises when CUDA is asked for (or defaulted
    to) and absent: a run never moves to the CPU unless the caller said so.
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
