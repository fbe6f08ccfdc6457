"""GQA-aware flash attention entry point, as the model calls it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D).  Returns (B, S, H, D).

    The kernel reads kv head h // (H // Hkv) for query head h in place, so
    nothing is repeated or transposed; strided inputs are made contiguous.
    """
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
