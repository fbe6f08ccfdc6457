"""Plain PyTorch version of the cache attention kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    WGMMA_HEAD_DIMS)
from repro_torch.kernels.flash_attention.ref import attention_tolerance

#: a masked slot's score: the JAX package's finite ``NEG_INF``
#: (``repro/models/layers.py``), so that a query with no live slot gets
#: the mean of V over every slot, as there
NEG_INF = -2.0e38


def cache_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int] = None) -> torch.Tensor:
    """(B, S, T) bool, True where query i may read slot t: the slot is
    written (k_pos >= 0), not after the query (k_pos <= q_pos) and, with a
    window, inside it (k_pos > q_pos - window).  The JAX package's
    ``_causal_window_mask`` with its ``valid`` slots."""
    kp = k_pos[:, None, :].long()
    qp = q_pos[:, :, None].long()
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask &= kp > qp - window
    return mask


def cache_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None,
                        return_lse: bool = False):
    """S queries over the whole cache, in f32.

    q: (B, S, H, D); k, v: (B, T, Hkv, D) with H a multiple of Hkv (query
    head h reads kv head h // (H // Hkv)); q_pos (B, S), k_pos (B, T).
    Scores scaled by 1 / sqrt(D), masked (``cache_mask``) to ``NEG_INF``,
    softmax over the T slots.  Returns (B, S, H, D) in q's dtype; with
    ``return_lse`` also each row's log-sum-exp of its live scores, f32
    (B, S, H), -inf where it has none (the kernel's)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (1.0 / d ** 0.5)
    mask = cache_mask(q_pos.to(q.device), k_pos.to(q.device),
                      window)[:, None]
    lse = (torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
           .transpose(1, 2) if return_lse else None)
    probs = torch.softmax(scores.masked_fill_(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)
    return (out, lse) if return_lse else out


def cache_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    plain: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """The largest |kernel - plain| allowed for each element of the cache
    kernel's output on these inputs (``plain``: the plain version's):
    ``attention_tolerance``, and where the bf16 tensor-core design runs
    (head_dim 64, 112, 128, 256), which rounds P to bf16 before P V as the
    flash kernel does, its ``P_ROUNDING`` term on attn(|v|) taken by the
    plain version in f32.  Returns f32 of ``plain``'s shape."""
    abs_attn = None
    if plain.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        abs_attn = cache_attention_ref(q.float(), k.float(), v.float().abs(),
                                       q_pos, k_pos, window=window)
    return attention_tolerance(plain, abs_attn)
