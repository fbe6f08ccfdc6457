"""GQA-aware flash attention entry point, as the model calls it.

``flash_mha`` is differentiable.  Its forward pass is the Hopper kernel (on
a CUDA tensor; the plain version on a CPU tensor, as the wrapper decides);
its backward pass recomputes the plain attention (``ref.attention_ref``)
under autograd from the saved q, k and v and differentiates that, keeping
GQA's kv-head mapping and the window.  That is the trade the JAX package
makes: it trains through plain chunked attention under ``jax.checkpoint``
(recomputed in the backward pass), and its Pallas kernel has no backward,
so neither has this one.  The kernel's output and the plain recompute
differ within the kernel's tolerance, so the gradients are close to the
plain route's, not equal.  The recompute materialises the (B, H, S, S)
scores of one layer at a time (f32); chunk the queries, as the JAX package
does, before the sequence grows far past a few thousand tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashMHA(torch.autograd.Function):
    """Forward through the kernel, backward through the plain recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need)
                       for t, need in zip(saved, ctx.needs_input_grad))
            out = attention_ref(q, k, v, causal=ctx.causal,
                                window=ctx.window)
            wrt = [t for t in (q, k, v) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if t.requires_grad else None
                  for t in (q, k, v)), None, None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D).  Returns (B, S, H, D).

    The kernel reads kv head h // (H // Hkv) for query head h in place, so
    nothing is repeated or transposed; strided inputs are made contiguous.
    Differentiable in q, k and v (see the module docstring); where none of
    them needs a gradient the wrapper is called without autograd's Function,
    which costs the host about as long as the kernel takes at small shapes.
    """
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention(q, k, v, causal=causal, window=window)
    return _FlashMHA.apply(q, k, v, causal, window)
