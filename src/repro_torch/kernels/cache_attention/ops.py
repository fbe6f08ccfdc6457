"""Cache attention as the model calls it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cache_attention.cache_attention import (
    cache_attention)


def cache_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              window: Optional[int] = None, return_lse: bool = False):
    """q: (B, S, H, D) at positions q_pos (B, S); the cache k, v (B, T,
    Hkv, D) holding positions k_pos (B, T), -1 for a slot not written.
    Returns (B, S, H, D), and with ``return_lse`` each row's log-sum-exp
    (B, S, H) as well.  The kernel reads the cache in place."""
    return cache_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_pos.to(torch.int32).contiguous(),
                           k_pos.to(torch.int32).contiguous(),
                           window=window, return_lse=return_lse)
