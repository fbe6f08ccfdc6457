"""GQA-aware decode attention entry point, as the model calls it."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention)


def decode_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); cache k, v: (B, T, Hkv, D); lengths: (B,).
    Returns (B, 1, H, D).  The kernel reads the cache in place."""
    out = decode_attention(q[:, 0].contiguous(), k.contiguous(),
                           v.contiguous(), lengths)
    return out[:, None]
