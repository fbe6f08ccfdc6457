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


#: kernel vs plain version, element by element: |out - plain| <=
#: ATTN_RTOL * |plain| + ATTN_ATOL * max(1, max |plain|).  Both compute in
#: f32 from the same inputs and sum in another order (the ATTN_ATOL term);
#: in bf16 each then rounds its output once, which moves an element by at
#: most 2^-7 of itself (the ATTN_RTOL term)
ATTN_ATOL = 2e-5
ATTN_RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}
#: bf16 flash only: the tensor-core kernel rounds each probability p_j to
#: bf16 (by at most 2^-8 of itself) before P V, while l sums the f32 p_j,
#: so an output moves by at most 2^-8 * sum_j p_j |v_j| / l; the rule allows
#: twice that, P_ROUNDING * attn(|v|)
P_ROUNDING = 2.0 ** -7


def attention_tolerance(plain: torch.Tensor,
                        abs_attn: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The largest |kernel - plain| allowed for each element of ``plain``
    (an attention output in its working dtype): the rule above, plus
    ``P_ROUNDING * abs_attn`` where ``abs_attn`` (attention of |v|, for the
    bf16 flash kernel) is given.  Returns f32 of ``plain``'s shape."""
    ref = plain.float().abs()
    tol = ATTN_RTOL[plain.dtype] * ref \
        + ATTN_ATOL * max(1.0, float(ref.max()) if ref.numel() else 1.0)
    if abs_attn is not None:
        tol = tol + P_ROUNDING * abs_attn.float()
    return tol


def flash_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    plain: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``attention_tolerance`` of the flash kernel's output on these inputs:
    in bf16 with the P-rounding term, attn(|v|) taken by the plain version
    in f32 (q, k, v in (B, S, H, D) / (B, S, Hkv, D) as ``attention_ref``)."""
    abs_attn = None
    if plain.dtype == torch.bfloat16:
        abs_attn = attention_ref(q.float(), k.float(), v.float().abs(),
                                 causal=causal, window=window)
    return attention_tolerance(plain, abs_attn)
