"""RWKV-6 (Finch) blocks of the port: the JAX package's ``models/rwkv6.py``.

[arXiv:2404.05892] Per head (dim N), with r/k/v/g projections of the
token-shift-mixed input and a per-channel data-dependent decay
``w_t = exp(-exp(w_base + lora_w(x)))``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T           (state: N x N per head)
    y_t = S_{t-1}^T r_t + v_t (u * k_t)^T r_t     (u = per-channel bonus)

The wkv recurrence runs as the JAX package's chunked scan (plain torch, as
it is plain jnp there: no kernel).  Decode carries (x_prev_tm, x_prev_cm,
S) per layer: O(1) per token, no KV cache.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import normal_init

Params = Mapping[str, torch.Tensor]

_MIX_NAMES = ("r", "k", "v", "w", "g")
#: chunk length for the chunked wkv scan (q^2 * n transient per chunk)
WKV_CHUNK = 64


def rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def time_mix_init(gen: torch.Generator, cfg: ArchConfig
                  ) -> Dict[str, torch.Tensor]:
    d, dev = cfg.d_model, gen.device
    m, rank_m, rank_w = len(_MIX_NAMES), cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    return {
        "mix_base": torch.full((m, d), 0.5, device=dev),
        "mix_lora_a": normal_init(gen, (d, m * rank_m)),
        "mix_lora_b": normal_init(gen, (m, rank_m, d)),
        "w_r": normal_init(gen, (d, d)),
        "w_k": normal_init(gen, (d, d)),
        "w_v": normal_init(gen, (d, d)),
        "w_g": normal_init(gen, (d, d)),
        "w_o": normal_init(gen, (d, d), 0.02 / max(1, cfg.n_layers) ** 0.5),
        "decay_base": torch.full((d,), -6.0, device=dev),
        "decay_lora_a": normal_init(gen, (d, rank_w)),
        "decay_lora_b": normal_init(gen, (rank_w, d)),
        "bonus": torch.full((d,), 0.5, device=dev),
        "ln_x_scale": torch.ones(d, device=dev),
        "ln_x_bias": torch.zeros(d, device=dev),
    }


def channel_mix_init(gen: torch.Generator, cfg: ArchConfig
                     ) -> Dict[str, torch.Tensor]:
    d, f, dev = cfg.d_model, cfg.d_ff, gen.device
    return {
        "mix_k": torch.full((d,), 0.5, device=dev),
        "mix_r": torch.full((d,), 0.5, device=dev),
        "w_key": normal_init(gen, (d, f)),
        "w_value": normal_init(gen, (f, d),
                               0.02 / max(1, cfg.n_layers) ** 0.5),
        "w_receptance": normal_init(gen, (d, d)),
    }


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the channel dim (RWKV's ln_x)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, n_heads, d // n_heads)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf.reshape(b, s, d) * scale + bias).to(x.dtype)


def _ddlerp(params: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift mix for each of r/k/v/w/g."""
    dt = x.dtype
    diff = x_prev - x
    mix_base = params["mix_base"].to(dt)
    base = x + diff * mix_base[0]                   # coarse mixed input
    rank = params["mix_lora_a"].shape[1] // len(_MIX_NAMES)
    lora_in = torch.tanh(base @ params["mix_lora_a"].to(dt))
    lora_in = lora_in.reshape(*lora_in.shape[:-1], len(_MIX_NAMES), rank)
    lora = torch.einsum("...mr,mrd->...md", lora_in,
                        params["mix_lora_b"].to(dt))
    return tuple(x + diff * (mix_base[i] + lora[..., i, :])
                 for i in range(len(_MIX_NAMES)))


def _decay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), data-dependent (f32 for stability)."""
    lora = torch.tanh(xw.float() @ params["decay_lora_a"].float()) \
        @ params["decay_lora_b"].float()
    return torch.exp(-torch.exp(params["decay_base"] + lora))


def _wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunked linear-attention scan with per-channel data-dependent decay.

    r/k/v/w: (B, S, H, N) f32 (w in (0,1)); u: (H, N); state: (B, H, N, N).
    Returns (y (B,S,H,N), final state).  Within each chunk the pairwise
    decay exp(L_{t-1} - L_s) is computed in log space and masked before the
    exp, so nothing overflows; the chunk summaries carry the state from one
    chunk to the next.  A length that is not a multiple of ``chunk`` runs
    as chunks of 1 (shorter than ``chunk``) or as one chunk of S.
    """
    b, s, h, n = r.shape
    if s % chunk != 0:
        chunk = 1 if s < chunk else s   # degenerate fallback for odd lengths
    nc = s // chunk
    logw = torch.log(torch.clamp(w, min=1e-12))            # <= 0
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)[None, :, :, None,
                                                         None]
    S = state.float()
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        r_i, k_i, v_i, lw_i = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        l = torch.cumsum(lw_i, dim=1)                      # L_t, inclusive
        l_prev = l - lw_i                                  # L_{t-1}
        # pairwise decay exp(L_{t-1}[t] - L[s]) for s < t, per channel
        ldiff = l_prev[:, :, None] - l[:, None, :]         # (B,t,s,H,N)
        ldiff = torch.where(strict, ldiff, -torch.inf)
        m = torch.einsum("bthn,bshn,btshn->bhts", r_i, k_i, torch.exp(ldiff))
        y = torch.einsum("bhts,bshn->bthn", m, v_i)
        # bonus diagonal: y_t += (r_t . u*k_t) v_t
        diag = torch.einsum("bthn,hn,bthn->bth", r_i, u, k_i)
        y = y + diag[..., None] * v_i
        # inter-chunk: y_t += (r_t * exp(L_{t-1})) . S_prev
        y = y + torch.einsum("bthn,bhnj->bthj", r_i * torch.exp(l_prev), S)
        # S' = diag(exp(L_Q)) S + sum_s exp(L_Q - L_s) k_s v_s^T
        l_last = l[:, -1]                                  # (B,H,N)
        k_tilde = k_i * torch.exp(l_last[:, None] - l)
        S = (torch.exp(l_last)[..., None] * S
             + torch.einsum("bshn,bshj->bhnj", k_tilde, v_i))
        ys.append(y)
    return torch.cat(ys, dim=1), S


def time_mix_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   x_prev: torch.Tensor, state: torch.Tensor):
    """x: (B, S, D); x_prev: (B, D) last token of the previous segment;
    state: (B, H, N, N).  Returns (out, new_x_prev, new_state)."""
    b, s, d = x.shape
    h, n = rwkv_heads(cfg), cfg.rwkv_head_dim
    dt = x.dtype

    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(params, x, shifted)

    r = (xr @ params["w_r"].to(dt)).reshape(b, s, h, n).float()
    k = (xk @ params["w_k"].to(dt)).reshape(b, s, h, n).float()
    v = (xv @ params["w_v"].to(dt)).reshape(b, s, h, n).float()
    g = xg @ params["w_g"].to(dt)
    w = _decay(params, xw).reshape(b, s, h, n)             # (0,1), f32
    u = params["bonus"].reshape(h, n)

    y, state = _wkv_chunked(r, k, v, w, u, state, WKV_CHUNK)
    y = y.reshape(b, s, d).to(dt)
    y = _group_norm(y, params["ln_x_scale"], params["ln_x_bias"], h)
    y = y * F.silu(g)
    return y @ params["w_o"].to(dt), x[:, -1], state.float()


def channel_mix_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                      x_prev: torch.Tensor):
    dt = x.dtype
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xk = x + (shifted - x) * params["mix_k"].to(dt)
    xr = x + (shifted - x) * params["mix_r"].to(dt)
    k = torch.square(torch.relu(xk @ params["w_key"].to(dt)))
    r = torch.sigmoid(xr @ params["w_receptance"].to(dt))
    return r * (k @ params["w_value"].to(dt)), x[:, -1]


def init_rwkv_state(cfg: ArchConfig, batch: int,
                    dtype: torch.dtype = torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    h, n = rwkv_heads(cfg), cfg.rwkv_head_dim
    return {
        "x_prev_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
        "x_prev_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
        "S": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
    }
