"""Mixture-of-Experts block of the port: the JAX package's ``models/moe.py``.

Top-k routing with GShard-style *grouped*, capacity-bounded, sort-based
dispatch.  The tokens are split into G groups, as many as the mesh has
batch shards (``pjit_utils.batch_shard_count``; one outside a mesh, and
one where G does not divide the tokens or a group would hold fewer tokens
than there are experts), and each group routes its own tokens into its own
capacity buffer.  The dispatch keeps the JAX package's rules, so the same
tokens are dropped: a group's (token, k) assignments are stably sorted by
expert, an assignment's rank is its place among its expert's
(``searchsorted``), ranks at or past the capacity go to an overflow bucket
that is thrown away, and a dropped assignment adds nothing (the token
keeps its residual).  Each expert product is one ``bmm`` with E its batch
dim over (E, G * C, D), as the JAX package's einsums contract
(``layers.matmul``): neither the expert stack nor its gradient is copied
over the G groups.

The combine has no atomics: each token has exactly ``top_k`` assignments,
which are put back in token order and summed over k one after another, so
reruns on the card are equal bit for bit (a scatter-add, as the JAX package
writes it, would add through atomics there, in an order that changes from
run to run).

On a mesh (DTensors inside ``activation_sharding``) the activations are
pinned where the JAX package pins them; the router, the sort, the rank and
the scatter, and the combine, run on each rank's own groups
(``pjit_utils.local``: DTensor has no rule for them, and the groups are the
batch dim that BATCH splits), and the expert products on DTensors with the
plan's weight placements (``layers.matmul``).

Auxiliary losses: Switch-style load balance and router z-loss, means over
(groups, tokens), and the share of assignments dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import matmul, normal_init
from repro_torch.utils import pjit_utils as pj
from repro_torch.utils.pjit_utils import BATCH, constrain

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


def groups_for(tokens: int, n_experts: int) -> int:
    """The routing groups of ``tokens`` tokens: the batch shards, or one
    where they do not divide the tokens or leave a group fewer tokens than
    experts (the JAX package's rule)."""
    groups = pj.batch_shard_count()
    if tokens % groups != 0 or tokens // groups < n_experts:
        return 1
    return groups


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


def _route(xt: torch.Tensor, router: torch.Tensor, e: int, k: int, c: int):
    """Router, top-k and dispatch of each group of ``xt`` (G, Tg, D).
    Returns the tensors the experts, the combine and the aux losses read,
    each with G leading: expert_in (G, E, C, D), the assignments' slots
    (dest_e, dest_c), ``inv`` (expert order -> flat (token, k) order), their
    weights (0 where dropped), keep, the router's probabilities, its
    log-sum-exps and the one-hot of the choices (G, Tg k, E)."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)                  # (G, Tg, E)
    top_w, top_e = top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    outs = []
    for g in range(xt.shape[0]):
        buf, dest_e, dest_c, order, sw, keep = _dispatch_one_group(
            xt[g], top_e[g], top_w[g], e, c)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        outs.append((buf[:-1], dest_e, dest_c, inv, sw * keep, keep))
    expert_in, dest_e, dest_c, inv, weights, keep = (
        torch.stack(z) for z in zip(*outs))
    assign = F.one_hot(top_e.reshape(top_e.shape[0], -1), e).float()
    return (expert_in, dest_e, dest_c, inv, weights, keep, probs,
            torch.logsumexp(logits, dim=-1), assign)


def _combine(expert_out: torch.Tensor, dest_e, dest_c, inv, weights, k: int
             ) -> torch.Tensor:
    """Each group's assignments' weighted outputs, back in (token, k)
    order, summed over k in a fixed order: (G, Tg, D)."""
    g, _, c, d = expert_out.shape
    pad = expert_out.new_zeros((g, 1, c, d))
    padded = torch.cat([expert_out, pad], dim=1)
    ys = []
    for i in range(g):
        vals = padded[i][dest_e[i], dest_c[i]] \
            * weights[i].to(expert_out.dtype)[:, None]
        vals = vals[inv[i]].view(-1, k, d)
        y = vals[:, 0]
        for j in range(1, k):
            y = y + vals[:, j]
        ys.append(y)
    return torch.stack(ys)


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
              capacity_override: Optional[int] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).  Dropped-token policy: residual
    only.  capacity_override: serving decode passes the token count
    (dropless); training and prefill keep capacity-bounded routing.  The
    capacity is per group (of T / G tokens)."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    groups = groups_for(t, e)
    tg = t // groups
    c = capacity_override if capacity_override is not None else capacity(
        tg, cfg)
    c = min(c, tg * k)
    xt = constrain(x.reshape(groups, tg, d), BATCH, None, None)
    router = params["router"].to(dt)

    def route(xl, rl):
        return _route(xl, rl, e, k, c)

    if pj.on_mesh(xt):
        rows = tuple(xt.placements)
        (expert_in, dest_e, dest_c, inv, weights, keep, probs, lse,
         assign) = pj.local(route, (rows,) * 9, xt, pj.whole(router))
    else:
        (expert_in, dest_e, dest_c, inv, weights, keep, probs, lse,
         assign) = route(xt, router)
    expert_in = constrain(expert_in, BATCH, None, None, None)  # (G,E,C,D)

    if cfg.mlp in ("swiglu", "geglu"):
        gate = matmul(expert_in, params["w_gate"].to(dt))
        gate = (F.silu(gate) if cfg.mlp == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        hidden = gate * matmul(expert_in, params["w_up"].to(dt))
    else:
        hidden = F.gelu(matmul(expert_in, params["w_gate"].to(dt)),
                        approximate="tanh")
    hidden = constrain(hidden, BATCH, None, None, "model")
    expert_out = matmul(hidden, params["w_down"].to(dt))     # (G,E,C,D)
    expert_out = constrain(expert_out, BATCH, None, None, None)

    def combine(eo, de, dc, iv, w):
        return _combine(eo, de, dc, iv, w, k)

    if pj.on_mesh(expert_out):
        y = pj.local(combine, tuple(expert_out.placements), expert_out,
                     dest_e, dest_c, inv, weights)
    else:
        y = combine(expert_out, dest_e, dest_c, inv, weights)
    y = constrain(y, BATCH, None, None)

    # means over (groups, tokens): each group holds as many tokens
    frac_assigned = pj.whole(assign.reshape(-1, e).mean(0)) * e
    mean_prob = pj.whole(probs.reshape(-1, e).mean(0)) * e
    lb_loss = torch.mean(frac_assigned * mean_prob)
    z_loss = pj.whole(lse.square().mean())
    aux = {"moe_lb": cfg.router_aux_weight * lb_loss,
           "moe_z": cfg.router_z_weight * z_loss,
           "moe_drop_frac": 1.0 - pj.whole(keep.float().mean())}
    return y.reshape(b, s, d), aux
