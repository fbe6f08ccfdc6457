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

  apply(batch, dtype) -> (logits, aux)        full-sequence forward
  forward(W, batch, dtype) -> (logits, aux)   the same over a tree ``W``
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
stacked layers computes the same).  Attention goes through the Hopper
kernels (their plain versions on CPU tensors); the MoE dispatch, the wkv
and SSD scans are plain torch, as they are plain jnp there.
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
from repro_torch.utils.device import resolve_device

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


def _attn_block_apply(p: Params, x, cfg: ArchConfig, positions, window,
                      cache, cache_pos, moe_capacity=None):
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    attn_out, new_cache = L.attention_apply(
        p["attn"], h, cfg, positions, window=window, cache=cache,
        cache_pos=cache_pos)
    x = x + attn_out
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    if cfg.is_moe:
        ffn_out, aux = MOE.moe_apply(p["moe"], h, cfg,
                                     capacity_override=moe_capacity)
    else:
        ffn_out, aux = L.mlp_apply(p["mlp"], h, cfg), {}
    return x + ffn_out, new_cache, aux


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
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    tm_out, xp_tm, s_new = R6.time_mix_apply(
        p["time_mix"], h, cfg, state["x_prev_tm"].to(x.dtype), state["S"])
    x = x + tm_out
    h = L.apply_norm(p["norm2"], x, cfg.norm)
    cm_out, xp_cm = R6.channel_mix_apply(p["channel_mix"], h, cfg,
                                         state["x_prev_cm"].to(x.dtype))
    new_state = ({"x_prev_tm": xp_tm, "x_prev_cm": xp_cm, "S": s_new}
                 if keep_state else None)
    return x + cm_out, new_state


def _mamba_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"norm": L.norm_init(cfg.d_model, cfg.norm, gen.device),
            "mamba": M2.mamba2_init(gen, cfg)}


def _mamba_block_apply(p: Params, x, cfg: ArchConfig, state):
    h = L.apply_norm(p["norm"], x, cfg.norm)
    out, new_state = M2.mamba2_apply(p["mamba"], h, cfg, state)
    return x + out, new_state


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
        if cfg.family == "audio":                 # tokens (B, S, C)
            h = sum(F.embedding(tok[..., i].long(), W["embed"][i]).to(dtype)
                    for i in range(cfg.n_codebooks))
        elif cfg.family == "vlm":                 # image prefix + text
            img = batch["image_embeds"].to(device=tok.device, dtype=dtype)
            h = torch.cat([img, F.embedding(tok.long(), W["embed"]).to(dtype)],
                          dim=1)
        else:
            h = F.embedding(tok.long(), W["embed"]).to(dtype)
        b, s = h.shape[:2]
        start = batch.get("start_pos")
        if start is None:
            start = torch.zeros((b,), dtype=torch.int32, device=tok.device)
        positions = start[:, None] + torch.arange(
            s, dtype=torch.int32, device=tok.device)[None]
        return h, positions

    def _run_attn_stack(self, W, x, positions, caches, cache_pos,
                        moe_capacity):
        cfg = self.cfg
        aux: Dict[str, torch.Tensor] = {}
        new_caches: List[Optional[Dict[str, torch.Tensor]]] = []
        for i, blk in enumerate(W["blocks"]):
            x, nc, aux_i = _attn_block_apply(
                blk, x, cfg, positions, cfg.sliding_window,
                caches[i] if caches is not None else None, cache_pos,
                moe_capacity)
            aux = _merge_aux(aux, aux_i)
            new_caches.append(nc)
        if cfg.is_moe and aux:
            aux = {k: v / cfg.n_layers for k, v in aux.items()}
        return x, (new_caches if caches is not None else None), aux

    def _run_rwkv_stack(self, W, x, states):
        new_states = []
        for i, blk in enumerate(W["blocks"]):
            x, ns = _rwkv_block_apply(
                blk, x, self.cfg, states[i] if states is not None else None)
            new_states.append(ns)
        return x, (new_states if states is not None else None), {}

    def _run_hybrid_stack(self, W, x, x0, positions, caches, cache_pos):
        """Zamba2: periods of ``shared_attn_period`` mamba blocks, each
        followed by the weight-shared attention block through its own
        (unshared) 2D -> D projection of concat(x, x0); the blocks past the
        last whole period run without it."""
        cfg = self.cfg
        period, has_cache = cfg.shared_attn_period, caches is not None
        new_m, new_s = [], []
        si = 0
        for i, blk in enumerate(W["blocks"]):
            x, ns = _mamba_block_apply(
                blk, x, cfg, caches["mamba"][i] if has_cache else None)
            new_m.append(ns)
            if (i + 1) % period == 0 and si < self.n_periods:
                inp = torch.cat([x, x0], dim=-1) @ W["shared_proj"][si].to(
                    x.dtype)
                out, nsc, _ = _attn_block_apply(
                    W["shared"], inp, cfg, positions, None,
                    caches["shared"][si] if has_cache else None, cache_pos)
                x = x + out
                new_s.append(nsc)
                si += 1
        if has_cache:
            return x, {"mamba": new_m, "shared": new_s, "tail": None}, {}
        return x, None, {}

    def _backbone(self, W: Params, batch, caches, cache_pos,
                  dtype=torch.float32, moe_capacity=None):
        cfg = self.cfg
        x, positions = self.embed(W, batch, dtype)
        if cfg.block_type == "attention":
            x, new_caches, aux = self._run_attn_stack(
                W, x, positions, caches, cache_pos, moe_capacity)
        elif cfg.block_type == "rwkv6":
            x, new_caches, aux = self._run_rwkv_stack(W, x, caches)
        else:
            x, new_caches, aux = self._run_hybrid_stack(
                W, x, x, positions, caches, cache_pos)
        return L.apply_norm(W["final_norm"], x, cfg.norm), new_caches, aux

    def logits(self, W: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = h.dtype
        if cfg.family == "audio":
            out = h @ W["lm_head"].to(dt)
            return out.reshape(*h.shape[:-1], cfg.n_codebooks,
                               cfg.vocab_size)
        if cfg.tie_embeddings:
            return h @ W["embed"].to(dt).T
        return h @ W["lm_head"].to(dt)

    def forward(self, W: Params, batch: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.float32):
        """Full-sequence logits over the parameter tree ``W`` (this model's
        layout; the layers cast matrices to ``dtype`` at use).  Autograd
        flows to ``W``'s leaves; ``aux`` holds the MoE auxiliaries (their
        mean over the layers), empty for the other families."""
        h, _, aux = self._backbone(W, batch, None, None, dtype)
        return self.logits(W, h), aux

    def apply(self, batch: Dict[str, torch.Tensor],
              dtype: torch.dtype = torch.float32):
        return self.forward(self.weights(dtype), batch, dtype)

    def features(self, batch: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._backbone(self.weights(dtype), batch, None, None,
                              dtype)[0]

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
                dtype: torch.dtype = torch.bfloat16):
        W = self.weights(dtype)
        batch = dict(batch, start_pos=cache["pos"])
        h, new_blocks, _ = self._backbone(W, batch, cache["blocks"],
                                          cache["pos"], dtype)
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + h.shape[1]}

    def decode_step(self, tokens: torch.Tensor, cache: Params,
                    dtype: torch.dtype = torch.bfloat16):
        """tokens: (B,) int (audio: (B, n_codebooks)).  MoE routing is
        dropless here (capacity = the batch's tokens), as in the JAX
        package."""
        cfg = self.cfg
        W = self.weights(dtype)
        b = tokens.shape[0]
        batch = {"tokens": tokens[:, None], "start_pos": cache["pos"]}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros((b, 0, cfg.d_model),
                                                dtype=dtype,
                                                device=tokens.device)
        h, new_blocks, _ = self._backbone(
            W, batch, cache["blocks"], cache["pos"], dtype,
            moe_capacity=b if cfg.is_moe else None)
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + 1}


def build_model(cfg: ArchConfig, device=None, seed: Optional[int] = 0
                ) -> Model:
    return Model(cfg, device=device, seed=seed)
