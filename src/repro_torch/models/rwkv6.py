"""RWKV-6 (Finch) blocks of the port: the JAX package's ``models/rwkv6.py``.

[arXiv:2404.05892] Per head (dim N), with r/k/v/g projections of the
token-shift-mixed input and a per-channel data-dependent decay
``w_t = exp(-exp(w_base + lora_w(x)))``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T           (state: N x N per head)
    y_t = S_{t-1}^T r_t + v_t (u * k_t)^T r_t     (u = per-channel bonus)

The wkv recurrence runs as the JAX package's chunked scan (plain torch, as
it is plain jnp there: no kernel).  Decode carries (x_prev_tm, x_prev_cm,
S) per layer: O(1) per token, no KV cache.

On a mesh (DTensor parameters and activations inside ``utils.pjit_utils.
activation_sharding``) the token shift runs with D split over ``model``,
as the plan splits the states ``x_prev_tm`` and ``x_prev_cm``, so that no
state is gathered; the products go through ``layers.matmul``; r, k, v
and the decay are pinned where the JAX package pins them (heads over
``model``) and the scan runs on each rank's batch rows and heads
(``pjit_utils.local``) with its state ``S`` split as the plan splits it.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import normal_init
from repro_torch.utils import pjit_utils as pj
from repro_torch.utils.pjit_utils import BATCH, constrain

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
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm (RWKV's ln_x) of x (B, S, H, N), returned as
    (B, S, H * N): on a mesh each rank's heads alone."""
    b, s, h, n = x.shape
    scale, bias = pj.whole(scale), pj.whole(bias)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = pj.pin_grad(((xf - mean) * torch.rsqrt(var + eps)).reshape(
        b, s, h * n))
    return (xf * scale + bias).to(x.dtype)


def _shift(x: torch.Tensor, x_prev: torch.Tensor):
    """(x, the previous token's x): ``x_prev`` (B, D) before x's first
    token.  On a mesh both with D over ``model``, the plan's split of the
    states, so that the state read and the one returned (``x[:, -1]``)
    keep it (x whole on each rank's rows is cut, not gathered).  The
    mixing vectors that then meet x are gathered whole (``pjit_utils.
    whole``: D numbers), so that DTensor lays the product out as x and
    not x as the vector (a layout whose backward the card's torch
    cannot redistribute; PERF.md §6)."""
    x = constrain(x, BATCH, None, "model")
    x_prev = constrain(x_prev, BATCH, "model")
    if x.shape[1] == 1:
        return x, x_prev[:, None]
    return x, torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift mix for each of r/k/v/w/g."""
    dt = x.dtype
    diff = x_prev - x
    mix_base = pj.whole(params["mix_base"].to(dt))
    base = x + diff * mix_base[0]                   # coarse mixed input
    rank = params["mix_lora_a"].shape[1] // len(_MIX_NAMES)
    lora_in = torch.tanh(L.matmul(base, params["mix_lora_a"].to(dt)))
    # rows whole before the (mixes, rank) view, which a split of the last
    # dim need not fall on
    lora_in = constrain(lora_in, BATCH, None, None)
    lora_in = lora_in.reshape(*lora_in.shape[:-1], len(_MIX_NAMES), rank)
    lora = _mix_lora(lora_in, params["mix_lora_b"].to(dt))
    return tuple(x + diff * (mix_base[i] + lora[..., i, :])
                 for i in range(len(_MIX_NAMES)))


def _mix_lora(lora_in: torch.Tensor, mix_b: torch.Tensor) -> torch.Tensor:
    """The five mixes' LoRA products, (..., 5, rank) x (5, rank, D).  On a
    mesh on each rank's rows against the whole stack (gathered: 5 x rank
    x D, a few MB): the rank dim they contract, which the plan splits
    over ``data`` in training, is then summed at once as on one device."""
    def mix(a, b):
        return torch.einsum("...mr,mrd->...md", a, b)

    if not pj.on_mesh(lora_in):
        return mix(lora_in, mix_b)
    return pj.local(mix, lora_in.placements, lora_in, pj.whole(mix_b))


def _decay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), data-dependent (f32 for stability)."""
    lora = L.matmul(torch.tanh(L.matmul(xw.float(),
                                        params["decay_lora_a"].float())),
                    params["decay_lora_b"].float())
    return torch.exp(-torch.exp(pj.whole(params["decay_base"]) + lora))


def _heads(t: torch.Tensor, h: int, n: int) -> torch.Tensor:
    """(B, S, H * N) -> (B, S, H, N), on a mesh the rows whole before the
    view (DTensor may split H * N where H does not divide) and the heads
    then over ``model`` (JAX's ``rwkv6.py:130-131``)."""
    b, s = t.shape[:2]
    t = constrain(t, BATCH, None, None).reshape(b, s, h, n)
    return constrain(t, BATCH, None, "model", None)


def _wkv_chunk(S, r_i, k_i, v_i, lw_i, u, strict):
    """One chunk of ``_wkv_chunked``: (S', y_i) from the state S (B·H, N,
    N) and the chunk's r, k, v and log-decays (B·H, q, N), each head a
    batch row, so that each contraction is one ``bmm``; u (B·H, 1, N)."""
    l = torch.cumsum(lw_i, dim=1)                          # L_t, inclusive
    l_prev = l - lw_i                                      # L_{t-1}
    # pairwise decay exp(L_{t-1}[t] - L[s]) for s < t, per channel
    ldiff = l_prev[:, :, None] - l[:, None]                # (BH,t,s,N)
    ldiff = torch.where(strict, ldiff, -torch.inf)
    m = (r_i[:, :, None] * k_i[:, None] * torch.exp(ldiff)).sum(-1)
    y = torch.bmm(m, v_i)                                  # (BH,t,N)
    # bonus diagonal: y_t += (r_t . u*k_t) v_t
    y = y + (r_i * u * k_i).sum(-1, keepdim=True) * v_i
    # inter-chunk: y_t += (r_t * exp(L_{t-1})) . S_prev
    y = y + torch.bmm(r_i * torch.exp(l_prev), S)
    # S' = diag(exp(L_Q)) S + sum_s exp(L_Q - L_s) k_s v_s^T
    l_last = l[:, -1:]                                     # (BH,1,N)
    k_tilde = k_i * torch.exp(l_last - l)
    S = (torch.exp(l_last).transpose(1, 2) * S
         + torch.bmm(k_tilde.transpose(1, 2), v_i))
    return S, y


def _wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunked linear-attention scan with per-channel data-dependent decay.

    r/k/v/w: (B, S, H, N) f32 (w in (0,1)); u: (H, N); state: (B, H, N, N).
    Returns (y (B,S,H,N), final state).  Within each chunk the pairwise
    decay exp(L_{t-1} - L_s) is computed in log space and masked before the
    exp, so nothing overflows; the chunk summaries carry the state from one
    chunk to the next.  A length that is not a multiple of ``chunk`` runs
    as chunks of 1 (shorter than ``chunk``) or as one chunk of S.  Where a
    gradient is taken each chunk's body is recomputed in the backward, as
    the JAX package checkpoints it: kept, its (B, H, q, q, N) pairwise
    decays would stay alive for every chunk (14.7 GiB a layer at one
    4,096-token row of rwkv6-7b, PERF.md §6).
    """
    b, s, h, n = r.shape
    if s % chunk != 0:
        chunk = 1 if s < chunk else s   # degenerate fallback for odd lengths
    nc = s // chunk
    logw = torch.log(torch.clamp(w, min=1e-12))            # <= 0
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)[:, :, None]
    body = _wkv_chunk
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        body = functools.partial(pj.checkpoint, _wkv_chunk)
    r, k, v, logw = (t.transpose(1, 2).reshape(b * h, s, n)
                     for t in (r, k, v, logw))
    u = u.expand(b, h, n).reshape(b * h, 1, n)
    S = state.float().reshape(b * h, n, n)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        S, y = body(S, r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, strict)
        ys.append(y)
    y = torch.cat(ys, dim=1).view(b, h, s, n).transpose(1, 2)
    return y, S.view(b, h, n, n)


def _wkv(r, k, v, w, bonus, state, n: int):
    """``_wkv_chunked`` at WKV_CHUNK, u the bonus (D,) as (H, N).  On a
    mesh on each rank's batch rows and heads (``pjit_utils.local``): the
    state pinned as JAX pins it on entry and after each chunk (BATCH,
    ``model``, None, None), the bonus split as r's heads are; y keeps r's
    placements."""
    def scan(r, k, v, w, bonus, state):
        return _wkv_chunked(r, k, v, w, bonus.reshape(-1, n), state,
                            WKV_CHUNK)

    if not pj.on_mesh(r):
        return scan(r, k, v, w, bonus, state)
    state = constrain(state.float(), BATCH, "model", None, None)
    return pj.local(scan, (r.placements, state.placements), r, k, v, w,
                    pj.align(bonus, 0, r, 2), state)


def time_mix_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   x_prev: torch.Tensor, state: torch.Tensor):
    """x: (B, S, D); x_prev: (B, D) last token of the previous segment;
    state: (B, H, N, N).  Returns (out, new_x_prev, new_state)."""
    h, n = rwkv_heads(cfg), cfg.rwkv_head_dim
    dt = x.dtype

    x, shifted = _shift(x, x_prev)
    xr, xk, xv, xw, xg = _ddlerp(params, x, shifted)

    r, k, v = (_heads(L.matmul(xi, params[name].to(dt)), h, n).float()
               for xi, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = L.matmul(xg, params["w_g"].to(dt))
    w = _heads(_decay(params, xw), h, n)                   # (0,1), f32

    y, state = _wkv(r, k, v, w, params["bonus"], state, n)
    y = _group_norm(y.to(dt), params["ln_x_scale"], params["ln_x_bias"])
    y = y * F.silu(g)
    # the new x_prev is a copy: a view of x would keep the whole (B, S, D)
    # input alive in the state a prefill returns
    return L.matmul(y, params["w_o"].to(dt)), x[:, -1].clone(), state.float()


def channel_mix_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                      x_prev: torch.Tensor):
    dt = x.dtype
    x, shifted = _shift(x, x_prev)
    xk = x + (shifted - x) * pj.whole(params["mix_k"].to(dt))
    xr = x + (shifted - x) * pj.whole(params["mix_r"].to(dt))
    k = torch.square(torch.relu(L.matmul(xk, params["w_key"].to(dt))))
    r = torch.sigmoid(L.matmul(xr, params["w_receptance"].to(dt)))
    return r * L.matmul(k, params["w_value"].to(dt)), x[:, -1].clone()


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
