"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

from typing import Optional

import torch

#: the kernel's mask value (the JAX kernel's ``NEG_INF``)
NEG_INF = -1.0e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Dense softmax attention in f32.

    q: (B, S, H, D); k, v: (B, S, Hkv, D) with H a multiple of Hkv (query
    head h reads kv head h // (H // Hkv)).  Returns (B, S, H, D) in q's
    dtype.  The counterpart of the JAX package's ``attention_ref`` in the
    layout of ``flash_mha``.
    """
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (1.0 / d ** 0.5)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)
