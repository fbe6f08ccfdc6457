"""Model layers of the port: the JAX package's ``models/layers.py`` in torch.

Conventions, as there:
  * params are plain mappings of tensors (the model keeps them as
    parameters in float32 and hands the layers matrices already cast to the
    activation dtype, norms in float32);
  * apply functions take any batch and sequence length;
  * attention supports MHA / GQA / MQA via n_kv_heads and causal and
    sliding-window masks, on the full sequence and on a KV cache;
  * softmax and norms accumulate in float32.

The attention core goes through the port's two Hopper kernels: full
sequences and prefill into a fresh cache through ``flash_mha`` (which also
covers the JAX package's query-chunked branch for long sequences), one token
over the cache through ``decode_mha``.  Caches are updated in place.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_mha
from repro_torch.kernels.flash_attention import flash_mha

Params = Mapping[str, torch.Tensor]

#: cached attention the port does not run yet
_CACHED_LATER = ("ROADMAP.md Queue 1 item 14e (ring-buffer window decode, "
                 "segments into a non-empty cache)")


# ---------------------------------------------------------------------------
# initializers (normal(0, scale) from an explicit generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: float = 0.02) -> torch.Tensor:
    return scale * torch.randn((in_dim, out_dim), generator=gen,
                               device=gen.device)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               scale: float = 0.02) -> torch.Tensor:
    return scale * torch.randn((vocab, dim), generator=gen,
                               device=gen.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, device=None) -> Dict[str, torch.Tensor]:
    if kind == "rms":
        return {"scale": torch.ones(d, device=device)}
    if kind == "layer":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(params: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    elif kind == "layer":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (D/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ArchConfig
                   ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d,
                         scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def attention_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor,
                    window: Optional[int] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence (cache=None) or cached (prefill/decode) attention.

    positions: (B, S) absolute token positions for RoPE.  cache: {"k":
    (B, T, Hkv, D), "v": ..., "pos": (B, T)}, written in place and
    returned; cache_pos: (B,) write offset of the first new token.  Three
    cached cases run, as the JAX package writes them: S == T (the segment
    fills the cache), a segment into a fresh cache (every cache_pos 0) and
    one token without a window (decode over slots < cache_pos + 1).  The
    others raise ``NotImplementedError``.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).view(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"].to(dt)).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"].to(dt)).view(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = flash_mha(q, k, v, causal=True, window=window)
    else:
        t = cache["k"].shape[1]
        # (a decode step never reads cache_pos on the host)
        if s == t or (1 < s < t and bool((cache_pos == 0).all())):
            # positions are consecutive, so the causal (and window) mask over
            # the new tokens is the kernel's index mask; the slots not
            # written here hold pos -1 and are masked in the JAX package
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            cache["pos"][:, :s] = positions
            out = flash_mha(q, k, v, causal=True, window=window)
        elif s == 1 and window is None:
            rows = torch.arange(b, device=x.device)
            slot = cache_pos.long()
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][rows, slot] = positions[:, 0].to(torch.int32)
            out = decode_mha(q, cache["k"].to(dt), cache["v"].to(dt),
                             cache_pos + 1)
        else:
            raise NotImplementedError(
                f"attention over a cache of {t} slots with {s} new tokens "
                f"and window {window} is not in the port yet "
                f"({_CACHED_LATER})")

    out = out.reshape(b, s, cfg.n_heads * hd)
    return out @ params["wo"].to(dt), cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int,
                    window: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    t = min(window, max_len) if window is not None else max_len
    return {
        "k": torch.zeros((batch, t, cfg.n_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, t, cfg.n_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, t), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    down_scale = 0.02 / max(1, cfg.n_layers) ** 0.5
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, f),
                "w_up": dense_init(gen, d, f),
                "w_down": dense_init(gen, f, d, scale=down_scale)}
    if cfg.mlp == "gelu":
        return {"w_in": dense_init(gen, d, f),
                "w_down": dense_init(gen, f, d, scale=down_scale)}
    raise ValueError(f"unknown mlp {cfg.mlp!r}")


def mlp_apply(params: Params, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        gate = x @ params["w_gate"].to(dt)
        gate = (F.silu(gate) if cfg.mlp == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        up = x @ params["w_up"].to(dt)
        return (gate * up) @ params["w_down"].to(dt)
    hidden = F.gelu(x @ params["w_in"].to(dt), approximate="tanh")
    return hidden @ params["w_down"].to(dt)
