"""Mixture-of-Experts block of the port: the JAX package's ``models/moe.py``.

Top-k routing with capacity-bounded, sort-based dispatch, in one group (the
JAX package splits the tokens into as many groups as the mesh has batch
shards; outside a mesh that is one).  The dispatch keeps the JAX package's
rules, so the same tokens are dropped: the (token, k) assignments are
stably sorted by expert, an assignment's rank is its place among its
expert's (``searchsorted``), ranks at or past the capacity go to an
overflow bucket that is thrown away, and a dropped assignment adds nothing
(the token keeps its residual).  The expert FFNs are batched matmuls, as
the JAX package's einsums.

The combine has no atomics: each token has exactly ``top_k`` assignments,
which are put back in token order and summed over k one after another, so
reruns on the card are equal bit for bit (a scatter-add, as the JAX package
writes it, would add through atomics there, in an order that changes from
run to run).

Auxiliary losses: Switch-style load balance and router z-loss, and the
share of assignments dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import normal_init

Params = Mapping[str, torch.Tensor]


def moe_init(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    down_scale = 0.02 / max(1, cfg.n_layers) ** 0.5
    return {"router": normal_init(gen, (d, e)),
            "w_gate": normal_init(gen, (e, d, f)),
            "w_up": normal_init(gen, (e, d, f)),
            "w_down": normal_init(gen, (e, f, d), down_scale)}


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    per_expert = tokens_per_group * cfg.top_k / cfg.n_experts
    return max(cfg.top_k, int(math.ceil(per_expert * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities and their experts, ties to the lower
    expert index first (``jax.lax.top_k``'s rule; a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_one_group(xt: torch.Tensor, top_e: torch.Tensor,
                        top_w: torch.Tensor, e: int, c: int):
    """Sort-based dispatch. xt: (T, D); top_e/top_w: (T, k).  Returns
    (expert_in (E+1, C, D), dest_e, dest_c, order, weights, keep), the
    assignments in expert order: ``order`` maps them to the flat (token, k)
    index, overflow goes to bucket E."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    sw = top_w.reshape(-1)[order]
    stok = torch.div(order, k, rounding_mode="floor")
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(t * k, device=xt.device) - first
    keep = rank < c
    dest_e = torch.where(keep, se, torch.full_like(se, e))
    dest_c = torch.where(keep, rank, torch.zeros_like(rank)) % c
    buf = xt.new_zeros((e + 1, c, xt.shape[-1]))
    # kept assignments own distinct slots; the overflow bucket is discarded
    buf = buf.index_put((dest_e, dest_c), xt[stok])
    return buf, dest_e, dest_c, order, sw, keep


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
              capacity_override: Optional[int] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).  Dropped-token policy: residual
    only.  capacity_override: serving decode passes the token count
    (dropless); training and prefill keep capacity-bounded routing."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    c = capacity_override if capacity_override is not None else capacity(
        t, cfg)
    c = min(c, t * k)
    xt = x.reshape(t, d)

    logits = (xt @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                  # (T, E)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    buf, dest_e, dest_c, order, sw, keep = _dispatch_one_group(
        xt, top_e, top_w, e, c)
    expert_in = buf[:-1]                                   # (E, C, D)

    if cfg.mlp in ("swiglu", "geglu"):
        gate = torch.matmul(expert_in, params["w_gate"].to(dt))
        gate = (F.silu(gate) if cfg.mlp == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        hidden = gate * torch.matmul(expert_in, params["w_up"].to(dt))
    else:
        hidden = F.gelu(torch.matmul(expert_in, params["w_gate"].to(dt)),
                        approximate="tanh")
    expert_out = torch.matmul(hidden, params["w_down"].to(dt))  # (E, C, D)

    # combine: each assignment's weighted output, back in (token, k) order,
    # summed over k in a fixed order
    pad = expert_out.new_zeros((1, c, d))
    vals = torch.cat([expert_out, pad])[dest_e, dest_c] \
        * (sw * keep).to(dt)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    vals = vals[inv].view(t, k, d)
    y = vals[:, 0]
    for j in range(1, k):
        y = y + vals[:, j]

    assign = F.one_hot(top_e.reshape(-1), e).float()
    frac_assigned = assign.mean(0) * e
    mean_prob = probs.mean(0) * e
    lb_loss = torch.mean(frac_assigned * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1).square())
    aux = {"moe_lb": cfg.router_aux_weight * lb_loss,
           "moe_z": cfg.router_z_weight * z_loss,
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y.view(b, s, d), aux
