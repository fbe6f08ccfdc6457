"""GQA-aware decode attention entry point, as the model calls it, and the
merge of its results over disjoint slices of one cache."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention)


def decode_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, return_lse: bool = False):
    """q: (B, 1, H, D); cache k, v: (B, T, Hkv, D); lengths: (B,).
    Returns (B, 1, H, D), and with ``return_lse`` each row's log-sum-exp
    (B, H) as well.  The kernel reads the cache in place."""
    out = decode_attention(q[:, 0].contiguous(), k.contiguous(),
                           v.contiguous(), lengths, return_lse=return_lse)
    if return_lse:
        return out[0][:, None], out[1]
    return out[:, None]


def merge_weights(lse: torch.Tensor,
                  slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weights of n slices' outputs from their log-sum-exps ``lse`` (n, ...):
    ``exp(lse_r - logsumexp_r lse_r)``, exactly 0 for a slice with no live
    slot (lse -inf).  Where no slice has one: 0, or with ``slots`` (n,),
    each slice's share of the slots, slots_r / sum(slots) (the mean over
    every slot that a cache attention row with no live slot takes, from
    each slice's mean over its own)."""
    top = torch.logsumexp(lse, dim=0)
    live = torch.isfinite(top)
    w = torch.exp(lse - torch.where(live, top, 0.0))
    w = torch.where(torch.isfinite(lse), w, 0.0)
    if slots is None:
        return w
    share = (slots.float() / slots.float().sum()).to(w.device)
    return torch.where(live, w, share.view(-1, *([1] * (w.dim() - 1))))


def merge_slices(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """One call's result from n calls over disjoint slices of its cache:
    ``outs`` (n, B, 1, H, D) and ``lses`` (n, B, H) as ``decode_mha``
    returns them with ``return_lse``; the sum of the outputs weighted by
    ``merge_weights``, in f32, in the outputs' dtype."""
    w = merge_weights(lses)[:, :, None, :, None]
    merged = torch.where(w > 0, w * outs.float(), 0.0).sum(0)
    return merged.to(outs.dtype)
