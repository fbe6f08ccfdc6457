"""Decoder model of the port: the JAX package's ``models/transformer.py``.

One ``Model`` covers all 10 assigned architectures:
  * dense / GQA / MQA transformer blocks (optionally sliding-window),
  * MoE blocks (top-k capacity routing, ``models.moe``),
  * RWKV6 blocks (attention-free, ``models.rwkv6``),
  * Mamba2 blocks + Zamba2's weight-shared attention block every k layers
    (``models.mamba2``),
  * vision / audio embedding frontends (stubbed as in the JAX package:
    image embeddings and codebook tokens arrive precomputed).

``Model`` is an ``nn.Module`` that holds its parameters (float32, no
gradients until ``train.loop.init_train_state`` makes them trainable) in
the JAX package's tree layout with blocks as a list:
``{"final_norm", "embed", ["lm_head"], ["shared", "shared_proj"],
"blocks": [per-layer tree, ...]}``.  Its methods mirror the JAX API
without the params argument:

  apply(batch, dtype, train) -> (logits, aux)   full-sequence forward
  forward(W, batch, dtype, train) -> (logits, aux)
                                              the same over a tree ``W``
                                              (differentiable: training)
  features(batch, dtype) -> (B, S, D)         final hidden
  init_cache(batch, max_len, dtype) -> cache
  prefill(batch, cache, dtype) -> (logits_last, cache)
  decode_step(tokens, cache, dtype) -> (logits, cache)   one token

A cache is ``{"blocks": ..., "pos": (B,)}``: per layer an attention cache
``{"k", "v", "pos"}`` (updated in place) or an rwkv state ``{"x_prev_tm",
"x_prev_cm", "S"}``; the hybrid's is ``{"mamba": [per-layer {"conv",
"ssm"}], "shared": [per-call attention cache], "tail": None}``.  Layers run
in a Python loop (the JAX package's reduced-config path; its scan over
stacked layers computes the same).  With ``cfg.remat`` (every config
sets it) and ``train`` each block is recomputed in the backward
(``pjit_utils.checkpoint``), zamba2's whole periods where
``cfg.scan_layers``, as the JAX package's ``jax.checkpoint``.  Attention
goes through the Hopper kernels (their plain versions on CPU tensors);
the MoE dispatch, the wkv and SSD scans are plain torch, as they are
plain jnp there.

On a mesh (``load_tree`` of DTensor leaves placed by ``launch.sharding``,
a DTensor batch, inside ``utils.pjit_utils.activation_sharding``) every
family (dense, MoE, vlm, audio, rwkv6, the mamba2/zamba2 hybrid; with or
without a window) runs the same methods: the activations pinned where the
JAX package pins them (``constrain``), the embedding a masked lookup of
each rank's slice of the vocabulary (summed over audio's codebooks, vlm's
image prefix joined to it), the attention on each rank's shards
(``layers._mesh_attention``; zamba2's shared block too), MoE's routing on
each rank's groups (``models.moe``), the wkv and SSD scans on each rank's
heads (``models.rwkv6``, ``models.mamba2``).  The rwkv and mamba states,
replaced each step, are returned in the placements they came in (the
plan's, ``launch.sharding.cache_shardings``); attention caches are
written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.utils import pjit_utils as pj
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pjit_utils import BATCH, constrain

Params = Dict[str, Any]

#: matrices the layers read in float32 whatever the activation dtype (the
#: JAX package's rwkv decay LoRA, kept f32 for stability)
_F32_LEAVES = ("decay_lora_a", "decay_lora_b")


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------

def _attn_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    p = {"norm1": L.norm_init(cfg.d_model, cfg.norm, gen.device),
         "attn": L.attention_init(gen, cfg),
         "norm2": L.norm_init(cfg.d_model, cfg.norm, gen.device)}
    if cfg.is_moe:
        p["moe"] = MOE.moe_init(gen, cfg)
    else:
        p["mlp"] = L.mlp_init(gen, cfg)
    return p


def _split_count(x, dim: int) -> int:
    """How many shards a DTensor's ``dim`` is cut into over its mesh."""
    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(i)
    return n


def _attn_block_apply(p: Params, x, cfg: ArchConfig, positions, window,
                      cache, cache_pos, moe_capacity=None):
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    attn_out, new_cache = L.attention_apply(
        p["attn"], h, cfg, positions, window=window, cache=cache,
        cache_pos=cache_pos)
    # on a mesh the norm's input on each rank's rows, whole: a tensor-
    # parallel product may leave D split (over ``data`` in training)
    x = constrain(x + attn_out, BATCH, None, None)
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    if cfg.is_moe:
        ffn_out, aux = MOE.moe_apply(p["moe"], h, cfg,
                                     capacity_override=moe_capacity)
    else:
        ffn_out, aux = L.mlp_apply(p["mlp"], h, cfg), {}
    return constrain(x + ffn_out, BATCH, None, None), new_cache, aux


def _rwkv_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"norm1": L.norm_init(cfg.d_model, cfg.norm, gen.device),
            "time_mix": R6.time_mix_init(gen, cfg),
            "norm2": L.norm_init(cfg.d_model, cfg.norm, gen.device),
            "channel_mix": R6.channel_mix_init(gen, cfg)}


def _rwkv_block_apply(p: Params, x, cfg: ArchConfig, state):
    keep_state = state is not None
    if not keep_state:
        state = R6.init_rwkv_state(cfg, x.shape[0], dtype=x.dtype,
                                   device=x.device)
        if pj.on_mesh(x):
            state = {k: pj.replicate(v, x.device_mesh)
                     for k, v in state.items()}
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    tm_out, xp_tm, s_new = R6.time_mix_apply(
        p["time_mix"], h, cfg, state["x_prev_tm"].to(x.dtype), state["S"])
    x = constrain(x + tm_out, BATCH, None, None)     # as in _attn_block
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    cm_out, xp_cm = R6.channel_mix_apply(p["channel_mix"], h, cfg,
                                         state["x_prev_cm"].to(x.dtype))
    new_state = ({k: pj.like(v, state[k]) for k, v in (
        ("x_prev_tm", xp_tm), ("x_prev_cm", xp_cm), ("S", s_new))}
        if keep_state else None)
    return constrain(x + cm_out, BATCH, None, None), new_state


def _mamba_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"norm": L.norm_init(cfg.d_model, cfg.norm, gen.device),
            "mamba": M2.mamba2_init(gen, cfg)}


def _mamba_block_apply(p: Params, x, cfg: ArchConfig, state):
    h = L.apply_norm(p["norm"], x, cfg.norm)
    out, new_state = M2.mamba2_apply(p["mamba"], h, cfg, state)
    if new_state is not None:
        new_state = {k: pj.like(v, state[k]) for k, v in new_state.items()}
    return constrain(x + out, BATCH, None, None), new_state


BLOCK_INIT = {"attention": _attn_block_init, "rwkv6": _rwkv_block_init,
              "mamba2": _mamba_block_init}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights as the JAX package draws them (normal(0, 0.02);
    output projections 0.02 / sqrt(n_layers); the rwkv and mamba constants
    as there), from ``gen``, on its device, in the tree layout above."""
    tree: Params = {"blocks": [BLOCK_INIT[cfg.block_type](gen, cfg)
                               for _ in range(cfg.n_layers)],
                    "final_norm": L.norm_init(cfg.d_model, cfg.norm,
                                              gen.device)}
    if cfg.family == "audio":
        tree["embed"] = torch.stack([
            L.embed_init(gen, cfg.vocab_size, cfg.d_model)
            for _ in range(cfg.n_codebooks)])
        tree["lm_head"] = L.dense_init(gen, cfg.d_model,
                                       cfg.n_codebooks * cfg.vocab_size)
    else:
        tree["embed"] = L.embed_init(gen, cfg.vocab_size, cfg.d_model)
        if not cfg.tie_embeddings:
            tree["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size)
    if cfg.shared_attn_period:
        tree["shared"] = _attn_block_init(
            gen, dataclasses.replace(cfg, n_experts=0))
        tree["shared_proj"] = torch.stack([
            L.dense_init(gen, 2 * cfg.d_model, cfg.d_model)
            for _ in range(cfg.n_layers // cfg.shared_attn_period)])
    return tree


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _module(tree: Params) -> nn.Module:
    """Nested dicts of tensors as (Module|Parameter)Dicts of frozen
    parameters that share the tensors' storage."""
    if all(torch.is_tensor(v) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _tree(module: nn.Module) -> Params:
    if isinstance(module, nn.ParameterDict):
        return dict(module)
    return {k: _tree(v) for k, v in module.items()}


def _cast(tree, dt: torch.dtype, name: str = ""):
    """``tree`` with its matrices in ``dt`` and its vectors (norms) as they
    are: what the JAX layers cast at use, cast once."""
    if isinstance(tree, dict):
        return {k: _cast(v, dt, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dt, name) for v in tree]
    if tree.dim() >= 2 and name not in _F32_LEAVES:
        return tree.detach().to(dt)
    return tree


def _embed_on_mesh(table, tok, dtype: torch.dtype):
    """The lookup of ``tok`` in a DTensor ``table`` (V, D).  The table is
    gathered over every mesh dim but ``model`` (FSDP's gather at use) and
    keeps its ``model`` split; the tokens are gathered over ``model``.  A
    vocabulary split: each rank looks up the tokens of its own slice (the
    others give exact zeros) and the result is Partial over ``model``, its
    sum (the caller's ``constrain``) the lookup.  A split of D: each rank
    looks up its columns.  DTensor's own ``aten.embedding`` fails on these
    layouts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    keep = {i: p.dim for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and names[i] == "model"}
    table = table.redistribute(mesh, tuple(
        table.placements[i] if i in keep else Replicate()
        for i in range(mesh.ndim)))
    if not pj.on_mesh(tok):
        tok = pj.replicate(tok, mesh)
    tok = constrain(tok, BATCH, None)
    tok = tok.redistribute(mesh, tuple(Replicate() if i in keep else p
                                       for i, p in enumerate(tok.placements)))
    r = pj.shard_index(table, 0)[0]

    def look(tab, t):
        idx = t.long() - r * tab.shape[0]
        hit = (idx >= 0) & (idx < tab.shape[0])
        h = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab).to(dtype)
        return torch.where(hit[..., None], h, 0.0)

    out = tuple((Partial() if keep[i] == 0 else Shard(tok.dim()))
                if i in keep else p for i, p in enumerate(tok.placements))
    return pj.local(look, out, table, tok)


def _remat(fn, remat: bool):
    """``fn``, or ``fn`` recomputed in the backward where ``remat``
    (``pjit_utils.checkpoint``): the JAX package's ``jax.checkpoint`` of
    a block when ``cfg.remat and train``."""
    if not remat:
        return fn
    return lambda *args: pj.checkpoint(fn, *args)


def _merge_aux(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]):
    for k, v in aux.items():
        acc[k] = acc.get(k, 0.0) + v
    return acc


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: Optional[int] = 0):
        """Parameters on ``device`` (the card unless asked), random from
        ``seed`` (``None``: left uninitialised, for a load)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.block_type == "mamba2" and not cfg.shared_attn_period:
            raise ValueError(f"{cfg.name}: mamba2 blocks run only in the "
                             f"hybrid stack (shared_attn_period > 0)")
        self.n_periods = (cfg.n_layers // cfg.shared_attn_period
                          if cfg.shared_attn_period else 0)
        gen = (L.Unfilled(dev) if seed is None else
               torch.Generator(device=dev).manual_seed(int(seed)))
        tree = init_params(cfg, gen)
        self.blocks = nn.ModuleList(_module(b) for b in tree["blocks"])
        self.final_norm = _module(tree["final_norm"])
        self.embed_table = nn.Parameter(tree["embed"], requires_grad=False)
        self.lm_head = (nn.Parameter(tree["lm_head"], requires_grad=False)
                        if "lm_head" in tree else None)
        self.shared = _module(tree["shared"]) if "shared" in tree else None
        self.shared_proj = (nn.Parameter(tree["shared_proj"],
                                         requires_grad=False)
                            if "shared_proj" in tree else None)
        self._casts: Dict[torch.dtype, Tuple[tuple, Params]] = {}

    # -- parameters ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed_table.device

    def tree(self) -> Params:
        """The parameters in the JAX package's tree layout (list form)."""
        out: Params = {"final_norm": _tree(self.final_norm),
                       "embed": self.embed_table,
                       "blocks": [_tree(blk) for blk in self.blocks]}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        if self.shared is not None:
            out["shared"] = _tree(self.shared)
            out["shared_proj"] = self.shared_proj
        return out

    def load_tree(self, tree: Params) -> None:
        """Replace every parameter by the leaf of ``tree`` (this model's
        layout) at its place, under the same name and with the same
        ``requires_grad``: a tree of DTensors (``launch.sharding.
        distribute``) puts the model on a mesh."""
        def assign(module: nn.Module, sub: Params):
            for k, v in sub.items():
                if isinstance(module, nn.ParameterDict):
                    module[k] = nn.Parameter(
                        v, requires_grad=module[k].requires_grad)
                else:
                    assign(module[k], v)

        for blk, sub in zip(self.blocks, tree["blocks"]):
            assign(blk, sub)
        assign(self.final_norm, tree["final_norm"])
        for name, key in (("embed_table", "embed"), ("lm_head", "lm_head"),
                          ("shared_proj", "shared_proj")):
            old = getattr(self, name)
            if old is not None:
                setattr(self, name, nn.Parameter(
                    tree[key], requires_grad=old.requires_grad))
        if self.shared is not None:
            assign(self.shared, tree["shared"])
        self._casts.clear()

    def weights(self, dtype: torch.dtype) -> Params:
        """The tree as the layers read it in ``dtype``: the parameters
        themselves in float32, else a copy with the matrices cast, made once
        per dtype and made again after a parameter changes."""
        if dtype == torch.float32:
            return self.tree()
        versions = tuple(p._version for p in self.parameters())
        hit = self._casts.get(dtype)
        if hit is None or hit[0] != versions:
            hit = (versions, _cast(self.tree(), dtype))
            self._casts[dtype] = hit
        return hit[1]

    # -- forward -------------------------------------------------------------
    def embed(self, W: Params, batch: Dict[str, torch.Tensor],
              dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (hidden (B,S,D), positions (B,S))."""
        cfg = self.cfg
        tok = batch["tokens"]
        mesh = pj.on_mesh(W["embed"])

        def look(table, t):
            if mesh:
                return _embed_on_mesh(table, t, dtype)
            return F.embedding(t.long(), table).to(dtype)

        if cfg.family == "audio":                 # tokens (B, S, C)
            h = sum(look(W["embed"][i], tok[..., i])
                    for i in range(cfg.n_codebooks))
        elif cfg.family == "vlm":                 # image prefix + text
            h = look(W["embed"], tok)
            img = batch["image_embeds"]
            if mesh and img.shape[1]:
                if not pj.on_mesh(img):
                    img = pj.replicate(img.to(tok.device), h.device_mesh)
                # both parts whole on each rank's rows before the join
                img = constrain(img.to(dtype), BATCH, None, None)
                h = torch.cat([img, constrain(h, BATCH, None, None)], dim=1)
            elif not mesh:
                img = img.to(device=tok.device, dtype=dtype)
                h = torch.cat([img, h], dim=1)
        else:
            h = look(W["embed"], tok)
        b, s = h.shape[:2]
        start = batch.get("start_pos")
        if start is None:
            start = torch.zeros((b,), dtype=torch.int32, device=tok.device)
        if pj.on_mesh(h):
            if not pj.on_mesh(start):
                start = pj.replicate(start, h.device_mesh)
            start = constrain(start, BATCH)
            positions = pj.local(
                lambda st: st[:, None] + torch.arange(
                    s, dtype=torch.int32, device=st.device)[None],
                start.placements, start)
        else:
            positions = start[:, None] + torch.arange(
                s, dtype=torch.int32, device=tok.device)[None]
        # the JAX package's anchor: batch over the data axes
        h = constrain(h, BATCH, None, None)
        return h, positions

    def _run_attn_stack(self, W, x, positions, caches, cache_pos,
                        moe_capacity, train):
        cfg = self.cfg
        body = _remat(_attn_block_apply, cfg.remat and train)
        aux: Dict[str, torch.Tensor] = {}
        new_caches: List[Optional[Dict[str, torch.Tensor]]] = []
        for i, blk in enumerate(W["blocks"]):
            x, nc, aux_i = body(
                blk, x, cfg, positions, cfg.sliding_window,
                caches[i] if caches is not None else None, cache_pos,
                moe_capacity)
            aux = _merge_aux(aux, aux_i)
            new_caches.append(nc)
        if cfg.is_moe and aux:
            aux = {k: v / cfg.n_layers for k, v in aux.items()}
        return x, (new_caches if caches is not None else None), aux

    def _run_rwkv_stack(self, W, x, states, train):
        body = _remat(_rwkv_block_apply, self.cfg.remat and train)
        new_states = []
        for i, blk in enumerate(W["blocks"]):
            x, ns = body(
                blk, x, self.cfg, states[i] if states is not None else None)
            new_states.append(ns)
        return x, (new_states if states is not None else None), {}

    def _run_hybrid_stack(self, W, x, x0, positions, caches, cache_pos,
                          train):
        """Zamba2: periods of ``shared_attn_period`` mamba blocks, each
        followed by the weight-shared attention block through its own
        (unshared) 2D -> D projection of concat(x, x0); the blocks past the
        last whole period run without it.  With remat (``cfg.remat`` and
        ``train``) each whole period is recomputed in the backward where
        ``cfg.scan_layers`` (the JAX package's checkpointed period scan,
        which saves one residual a period), and the tail blocks each; else
        each mamba block and each shared call (its loop path)."""
        cfg = self.cfg
        period, has_cache = cfg.shared_attn_period, caches is not None
        remat = cfg.remat and train

        def mamba_body(x, blk, st):
            return _mamba_block_apply(blk, x, cfg, st)

        def shared_body(x, proj, cache):
            inp = constrain(L.matmul(torch.cat([x, x0], dim=-1),
                                     proj.to(x.dtype)),
                            BATCH, None, None)    # a block's input
            out, nc, _ = _attn_block_apply(W["shared"], inp, cfg, positions,
                                           None, cache, cache_pos)
            return x + out, nc

        if remat and cfg.scan_layers and not has_cache:
            def period_body(x, j):
                for blk in W["blocks"][j * period:(j + 1) * period]:
                    x = mamba_body(x, blk, None)[0]
                return shared_body(x, W["shared_proj"][j], None)[0]

            for j in range(self.n_periods):
                x = pj.checkpoint(period_body, x, j)
            for blk in W["blocks"][self.n_periods * period:]:
                x = pj.checkpoint(mamba_body, x, blk, None)[0]
            return x, None, {}
        mamba_body = _remat(mamba_body, remat)
        shared_body = _remat(shared_body, remat)
        new_m, new_s = [], []
        si = 0
        for i, blk in enumerate(W["blocks"]):
            x, ns = mamba_body(x, blk,
                               caches["mamba"][i] if has_cache else None)
            new_m.append(ns)
            if (i + 1) % period == 0 and si < self.n_periods:
                x, nsc = shared_body(
                    x, W["shared_proj"][si],
                    caches["shared"][si] if has_cache else None)
                new_s.append(nsc)
                si += 1
        if has_cache:
            return x, {"mamba": new_m, "shared": new_s, "tail": None}, {}
        return x, None, {}

    def _backbone(self, W: Params, batch, caches, cache_pos, train,
                  dtype=torch.float32, moe_capacity=None):
        cfg = self.cfg
        x, positions = self.embed(W, batch, dtype)
        if cfg.block_type == "attention":
            x, new_caches, aux = self._run_attn_stack(
                W, x, positions, caches, cache_pos, moe_capacity, train)
        elif cfg.block_type == "rwkv6":
            x, new_caches, aux = self._run_rwkv_stack(W, x, caches, train)
        else:
            x, new_caches, aux = self._run_hybrid_stack(
                W, x, x, positions, caches, cache_pos, train)
        return L.apply_norm(W["final_norm"], x, cfg.norm), new_caches, aux

    def logits(self, W: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = h.dtype
        if cfg.family == "audio":
            out = L.matmul(h, W["lm_head"].to(dt))
            if pj.on_mesh(out) and cfg.n_codebooks % _split_count(out, -1):
                # the (C * V) dim split over more ranks than C divides
                # into: JAX's reshape keeps each rank's slice of one
                # codebook, which no DTensor placement can name, so the
                # dim is brought whole first (the result splits V below)
                out = constrain(out, BATCH, *([None] * (out.ndim - 1)))
            out = out.reshape(*h.shape[:-1], cfg.n_codebooks,
                              cfg.vocab_size)
        elif cfg.tie_embeddings:
            out = L.matmul(h, W["embed"].to(dt).T)
        else:
            out = L.matmul(h, W["lm_head"].to(dt))
        return constrain(out, BATCH, *([None] * (out.ndim - 2)), "model")

    def forward(self, W: Params, batch: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.float32, train: bool = True):
        """Full-sequence logits over the parameter tree ``W`` (this model's
        layout; the layers cast matrices to ``dtype`` at use).  Autograd
        flows to ``W``'s leaves; ``aux`` holds the MoE auxiliaries (their
        mean over the layers), empty for the other families.  ``train``
        as the JAX package's ``apply``: with ``cfg.remat`` each block's
        activations are recomputed in the backward instead of kept."""
        h, _, aux = self._backbone(W, batch, None, None, train, dtype)
        return self.logits(W, h), aux

    def apply(self, batch: Dict[str, torch.Tensor],
              dtype: torch.dtype = torch.float32, train: bool = True):
        return self.forward(self.weights(dtype), batch, dtype, train)

    def features(self, batch: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._backbone(self.weights(dtype), batch, None, None,
                              False, dtype)[0]

    # -- caches / serving ----------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Params:
        cfg, dev = self.cfg, self.device
        if cfg.block_type == "attention":
            blocks: Any = [L.init_attn_cache(cfg, batch_size, max_len,
                                             window=cfg.sliding_window,
                                             dtype=dtype, device=dev)
                           for _ in range(cfg.n_layers)]
        elif cfg.block_type == "rwkv6":
            blocks = [R6.init_rwkv_state(cfg, batch_size, dtype, dev)
                      for _ in range(cfg.n_layers)]
        else:
            blocks = {"mamba": [M2.init_mamba_state(cfg, batch_size, dtype,
                                                    dev)
                                for _ in range(cfg.n_layers)],
                      "shared": [L.init_attn_cache(cfg, batch_size, max_len,
                                                   dtype=dtype, device=dev)
                                 for _ in range(self.n_periods)],
                      "tail": None}
        return {"blocks": blocks,
                "pos": torch.zeros((batch_size,), dtype=torch.int32,
                                   device=dev)}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Params,
                dtype: torch.dtype = torch.bfloat16,
                params: Optional[Params] = None):
        """``params``: the tree the layers read (this model's layout, any
        dtype; the matrices are cast at use), ``weights(dtype)`` if None."""
        W = self.weights(dtype) if params is None else params
        batch = dict(batch, start_pos=cache["pos"])
        h, new_blocks, _ = self._backbone(W, batch, cache["blocks"],
                                          cache["pos"], False, dtype)
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + h.shape[1]}

    def decode_step(self, tokens: torch.Tensor, cache: Params,
                    dtype: torch.dtype = torch.bfloat16,
                    params: Optional[Params] = None):
        """tokens: (B,) int (audio: (B, n_codebooks)).  MoE routing is
        dropless here (capacity = the batch's tokens), as in the JAX
        package.  ``params`` as ``prefill``'s."""
        cfg = self.cfg
        W = self.weights(dtype) if params is None else params
        b = tokens.shape[0]
        batch = {"tokens": tokens[:, None], "start_pos": cache["pos"]}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros((b, 0, cfg.d_model),
                                                dtype=dtype,
                                                device=tokens.device)
        h, new_blocks, _ = self._backbone(
            W, batch, cache["blocks"], cache["pos"], False, dtype,
            moe_capacity=b if cfg.is_moe else None)
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + 1}


def build_model(cfg: ArchConfig, device=None, seed: Optional[int] = 0
                ) -> Model:
    return Model(cfg, device=device, seed=seed)
