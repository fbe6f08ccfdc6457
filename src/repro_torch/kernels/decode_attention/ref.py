"""Plain PyTorch version of the decode attention kernel."""
from __future__ import annotations

import torch

#: the kernel's mask value (the JAX kernel's ``NEG_INF``)
NEG_INF = -1.0e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """One query token over a KV cache, in f32.

    q: (B, H, D); k, v: (B, T, Hkv, D) with H a multiple of Hkv; lengths:
    (B,) valid slots per row (slots >= lengths[b] are masked).  Returns
    (B, H, D) in q's dtype.  The counterpart of the JAX package's
    ``decode_attention_ref`` in the cache layout of ``decode_mha``.
    """
    b, h, d = q.shape
    t = k.shape[1]
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) * (1.0 / d ** 0.5)
    pos = torch.arange(t, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, vf).to(q.dtype)
