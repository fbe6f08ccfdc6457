"""Plain PyTorch version of the decode attention kernel."""
from __future__ import annotations

import torch

#: the kernel's mask value (the JAX kernel's ``NEG_INF``)
NEG_INF = -1.0e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, return_lse: bool = False):
    """One query token over a KV cache, in f32.

    q: (B, H, D); k, v: (B, T, Hkv, D) with H a multiple of Hkv; lengths:
    (B,) valid slots per row (slots >= lengths[b] are masked).  Returns
    (B, H, D) in q's dtype.  The counterpart of the JAX package's
    ``decode_attention_ref`` in the cache layout of ``decode_mha``.  With
    ``return_lse`` also the log-sum-exp of each row's scaled scores over
    its live slots, f32 (B, H), -inf where it has none (the kernel's).
    """
    b, h, d = q.shape
    t = k.shape[1]
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) * (1.0 / d ** 0.5)
    pos = torch.arange(t, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), dim=-1)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, vf).to(q.dtype)
    return (out, lse) if return_lse else out


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               chunk: int, return_lse: bool = False):
    """The kernel's split and merge in plain PyTorch, in f32.

    The cache is cut into chunks of ``chunk`` slots; each chunk i gives the
    partial max m_i, sum l_i and accumulator acc_i of its live slots (a
    chunk with none gives m_i = -inf, l_i = 0), and the merge takes m* =
    max m_i over the chunks with l_i > 0, l = sum e^{m_i - m*} l_i and out =
    sum e^{m_i - m*} acc_i / max(l, 1e-20), chunks with l_i = 0 adding
    exactly nothing.  Slots at or past ``lengths`` add exactly nothing
    either, whatever they hold.  Same arguments and result as
    ``decode_attention_ref``; the log-sum-exp is the merge's m* + log l,
    -inf where l = 0.
    """
    b, h, d = q.shape
    t = k.shape[1]
    rep = h // k.shape[2]
    n_split = max(1, -(-t // chunk))
    pad = n_split * chunk - t
    kf = torch.nn.functional.pad(k.float().repeat_interleave(rep, dim=2),
                                 (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float().repeat_interleave(rep, dim=2),
                                 (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) * (1.0 / d ** 0.5)
    pos = torch.arange(n_split * chunk, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = s.masked_fill(~valid, float("-inf")).view(b, h, n_split, chunk)
    vf = vf.masked_fill(~valid[:, 0, :, None, None], 0.0)   # never read
    m = s.amax(-1)                                        # (B, H, n)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l_part = p.sum(-1)
    acc = torch.einsum("bhnc,bnchd->bhnd", p,
                       vf.view(b, n_split, chunk, h, d))
    live = l_part > 0
    m_all = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(torch.isfinite(m_all),
                                                    m_all, 0.0)), 0.0)
    l_all = (w * l_part).sum(-1)
    out = (w[..., None] * acc).sum(-2) / l_all.clamp_min(1e-20)[..., None]
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(l_all > 0, m_all[..., 0] + torch.log(l_all),
                      float("-inf"))
    return out.to(q.dtype), lse
