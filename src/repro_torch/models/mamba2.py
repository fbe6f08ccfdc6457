"""Mamba2 (SSD) block of the port: the JAX package's ``models/mamba2.py``
[used by Zamba2, arXiv:2411.15242].

State-space duality form: per head h with scalar decay a_t = exp(dt_t * A_h)
(A_h < 0), inputs x (T,H,P), B/C (T,G,N) (G groups broadcast over heads):

    S_t = a_t S_{t-1} + dt_t * B_t (x) x_t         (state: H x P x N)
    y_t = C_t . S_t + D_h x_t

The chunked algorithm: an intra-chunk quadratic attention-like term plus a
state carried from chunk to chunk, with the decay algebra in log space (the
exps are <= 1).  Plain torch, as it is plain jnp there: no kernel.  Decode
is the same function on one token with the conv window and the SSM state
carried.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import normal_init

Params = Mapping[str, torch.Tensor]


def dims(cfg: ArchConfig) -> Tuple[int, int]:
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, conv_dim


def mamba2_init(gen: torch.Generator, cfg: ArchConfig
                ) -> Dict[str, torch.Tensor]:
    d, dev = cfg.d_model, gen.device
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    d_inner, conv_dim = dims(cfg)
    return {
        # order: [z (d_inner) | xBC (conv_dim) | dt (H)]
        "in_proj": normal_init(gen, (d, 2 * d_inner + 2 * g * n + h)),
        "conv_w": normal_init(gen, (cfg.conv_width, conv_dim), 0.1),
        "conv_b": torch.zeros(conv_dim, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.full((h,), math.log(math.expm1(1e-2)), device=dev),
        "norm_scale": torch.ones(d_inner, device=dev),
        "out_proj": normal_init(gen, (d_inner, d),
                                0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis. xbc: (B, S, C)."""
    kw, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    # windowed sum: sum_j w[j] * x[t - (kw-1) + j]
    out = sum(pad[:, j:j + s] * w[j].to(xbc.dtype) for j in range(kw))
    return F.silu(out + b.to(xbc.dtype))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, T, H, P); dt: (B, T, H); B/C: (B, T, G, N); A: (H,) negative.
    T must be a multiple of ``chunk``.  Returns (y (B,T,H,P), final state
    (B,H,P,N)).  All in f32.
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of chunk {chunk}")
    nc = t // chunk
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    logdec = dtc * A                                  # (b,nc,q,h) <= 0
    l = torch.cumsum(logdec, dim=2)                   # within-chunk cumsum
    l_last = l[:, :, -1]                              # (b,nc,h)

    # intra-chunk: M[t,s] = (C_t . B_s) exp(l_t - l_s) for s <= t, masked in
    # log space before the exp
    score = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc)
    lh = l.permute(0, 1, 3, 2)                        # (b,nc,h,q)
    ldiff = lh[..., :, None] - lh[..., None, :]       # l_q - l_s
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    ldiff = torch.where(causal, ldiff, -torch.inf)
    m = score * torch.exp(ldiff)
    dx = dtc[..., None] * xc                          # (b,nc,q,h,p)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", m, dx)

    # chunk summary state: S_c = sum_s exp(l_last - l_s) dx_s (x) B_s
    w_state = torch.exp(l_last[:, :, None] - l)       # (b,nc,q,h)
    s_chunk = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w_state, dx, Bc)

    # the state entering each chunk, carried over the chunks
    dec_chunk = torch.exp(l_last)                     # (b,nc,h)
    s_run = (x.new_zeros((b, h, p, n)) if state0 is None
             else state0.float())
    s_prev = []
    for ci in range(nc):
        s_prev.append(s_run)
        s_run = dec_chunk[:, ci, :, None, None] * s_run + s_chunk[:, ci]
    s_prev = torch.stack(s_prev, dim=1)               # (b,nc,h,p,n)

    # inter-chunk contribution: y_t += exp(l_t) C_t . S_prev
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(l), Cc,
                           s_prev)
    return (y_intra + y_inter).reshape(b, t, h, p), s_run


def mamba2_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence forward (and decode, at S = 1).  x: (B, S, D).  state
    (optional) carries {"conv": (B, kw-1, conv_dim), "ssm": (B, H, P, N)}
    across segments; a new one is returned with it."""
    b, s, _ = x.shape
    dt_ = x.dtype
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    d_inner, _ = dims(cfg)
    zxbcdt = x @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:-h]
    dt_raw = zxbcdt[..., -h:]

    if state is not None:
        xbc_in = torch.cat([state["conv"].to(dt_), xbc], dim=1)
        conv_out = _causal_conv(xbc_in, params["conv_w"],
                                params["conv_b"])[:, -s:]
        new_conv = xbc_in[:, -(cfg.conv_width - 1):]
    else:
        conv_out = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        new_conv = xbc[:, -(cfg.conv_width - 1):]

    x_ssd = conv_out[..., :d_inner].reshape(b, s, h, p).float()
    B = conv_out[..., d_inner:d_inner + g * n].reshape(b, s, g, n)
    C = conv_out[..., d_inner + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        chunk = 1 if s == 1 else s   # degenerate safe fallback
    y, s_final = ssd_chunked(x_ssd, dt, B.float(), C.float(), A, chunk,
                             state["ssm"] if state is not None else None)
    y = y + params["D"][None, None, :, None] * x_ssd
    y = y.reshape(b, s, d_inner).to(dt_)
    y = _gated_rmsnorm(y, z, params["norm_scale"])
    out = y @ params["out_proj"].to(dt_)
    new_state = ({"conv": new_conv, "ssm": s_final}
                 if state is not None else None)
    return out, new_state


def init_mamba_state(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16, device=None
                     ) -> Dict[str, torch.Tensor]:
    _, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
