"""Decoder model of the port: the JAX package's ``models/transformer.py``
for dense attention blocks.

``Model`` is an ``nn.Module`` that holds its parameters (float32, no
gradients until ``train.loop.init_train_state`` makes them trainable) in
the JAX package's tree layout with blocks as a list:
``{"final_norm", "embed", ["lm_head"], "blocks": [{"norm1", "attn",
"norm2", "mlp"}, ...]}``.  Its methods mirror the JAX API without the
params argument:

  init(seed)                                  random weights, in place
  apply(batch, dtype) -> (logits, aux)        full-sequence forward
  forward(W, batch, dtype) -> (logits, aux)   the same over a tree ``W``
                                              (differentiable: training)
  features(batch, dtype) -> (B, S, D)         final hidden
  init_cache(batch, max_len, dtype) -> cache
  prefill(batch, cache, dtype) -> (logits_last, cache)
  decode_step(tokens, cache, dtype) -> (logits, cache)   one token

A cache is ``{"blocks": [per-layer {"k", "v", "pos"}], "pos": (B,)}``,
updated in place.  Layers run in a Python loop (no scan).  Attention goes
through the Hopper kernels (their plain versions on CPU tensors).  Other
block types and families raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device

Params = Dict[str, Any]

_FAMILIES_LATER = ("ROADMAP.md Queue 1 item 14d (MoE, rwkv6, mamba2/hybrid, "
                   "vlm/audio)")


def _check_supported(cfg: ArchConfig) -> None:
    what = None
    if cfg.block_type != "attention":
        what = f"block_type {cfg.block_type!r}"
    elif cfg.family != "dense":
        what = f"family {cfg.family!r}"
    elif cfg.is_moe:
        what = "MoE blocks"
    if what is not None:
        raise NotImplementedError(f"{what} ({cfg.name}) is not in the port "
                                  f"yet ({_FAMILIES_LATER})")


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


def _cast(tree, dt: torch.dtype):
    """``tree`` with its matrices in ``dt`` and its vectors (norms) as they
    are: what the JAX layers cast at use, cast once."""
    if isinstance(tree, dict):
        return {k: _cast(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dt) for v in tree]
    return tree.detach().to(dt) if tree.dim() >= 2 else tree


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: Optional[int] = 0):
        """Parameters on ``device`` (the card unless asked), random from
        ``seed`` (``None``: left uninitialised, for a load)."""
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        e = lambda *shape: torch.empty(shape, device=dev)   # noqa: E731
        d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

        def block() -> nn.ModuleDict:
            ffn = ({"w_gate": e(d, f), "w_up": e(d, f), "w_down": e(f, d)}
                   if cfg.mlp in ("swiglu", "geglu")
                   else {"w_in": e(d, f), "w_down": e(f, d)})
            return nn.ModuleDict({
                "norm1": _params(L.norm_init(d, cfg.norm, dev)),
                "attn": _params({"wq": e(d, cfg.n_heads * hd),
                                 "wk": e(d, cfg.n_kv_heads * hd),
                                 "wv": e(d, cfg.n_kv_heads * hd),
                                 "wo": e(cfg.n_heads * hd, d)}),
                "norm2": _params(L.norm_init(d, cfg.norm, dev)),
                "mlp": _params(ffn)})

        self.blocks = nn.ModuleList(block() for _ in range(cfg.n_layers))
        self.final_norm = _params(L.norm_init(d, cfg.norm, dev))
        self.embed_table = nn.Parameter(e(cfg.vocab_size, d),
                                        requires_grad=False)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(e(d, cfg.vocab_size),
                                     requires_grad=False))
        self._casts: Dict[torch.dtype, Tuple[tuple, Params]] = {}
        if seed is not None:
            self.init(seed)

    # -- parameters ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed_table.device

    def tree(self) -> Params:
        """The parameters in the JAX package's tree layout (list form)."""
        out: Params = {"final_norm": dict(self.final_norm),
                       "embed": self.embed_table,
                       "blocks": [{k: dict(v) for k, v in blk.items()}
                                  for blk in self.blocks]}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        return out

    @torch.no_grad()
    def init(self, seed: int = 0) -> None:
        """Random weights as the JAX package draws them (normal(0, 0.02);
        output projections 0.02 / sqrt(n_layers); norms 1 and 0), from a
        ``torch.Generator`` on the parameters' device seeded with ``seed``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for blk in self.blocks:
            for name, w in {**blk["attn"], **blk["mlp"]}.items():
                if name in ("wo", "w_down"):
                    w.copy_(L.dense_init(gen, *w.shape, scale=0.02 / max(
                        1, cfg.n_layers) ** 0.5))
                else:
                    w.copy_(L.dense_init(gen, *w.shape))
            for norm in ("norm1", "norm2"):
                for name, p in blk[norm].items():
                    p.fill_(1.0 if name == "scale" else 0.0)
        for name, p in self.final_norm.items():
            p.fill_(1.0 if name == "scale" else 0.0)
        self.embed_table.copy_(L.embed_init(gen, cfg.vocab_size, cfg.d_model))
        if self.lm_head is not None:
            self.lm_head.copy_(L.dense_init(gen, cfg.d_model, cfg.vocab_size))

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
        tok = batch["tokens"]
        b, s = tok.shape[:2]
        h = F.embedding(tok.long(), W["embed"]).to(dtype)
        start = batch.get("start_pos")
        if start is None:
            start = torch.zeros((b,), dtype=torch.int32, device=tok.device)
        positions = start[:, None] + torch.arange(
            s, dtype=torch.int32, device=tok.device)[None]
        return h, positions

    def _run_attn_stack(self, W: Params, x, positions, window, caches,
                        cache_pos):
        cfg = self.cfg
        new_caches: List[Optional[Dict[str, torch.Tensor]]] = []
        for i, blk in enumerate(W["blocks"]):
            h = L.apply_norm(blk["norm1"], x, cfg.norm)
            attn_out, nc = L.attention_apply(
                blk["attn"], h, cfg, positions, window=window,
                cache=caches[i] if caches is not None else None,
                cache_pos=cache_pos)
            x = x + attn_out
            h = L.apply_norm(blk["norm2"], x, cfg.norm)
            x = x + L.mlp_apply(blk["mlp"], h, cfg)
            new_caches.append(nc)
        return x, (new_caches if caches is not None else None)

    def _backbone(self, W: Params, batch, caches, cache_pos,
                  dtype=torch.float32):
        cfg = self.cfg
        x, positions = self.embed(W, batch, dtype)
        x, new_caches = self._run_attn_stack(W, x, positions,
                                             cfg.sliding_window, caches,
                                             cache_pos)
        return L.apply_norm(W["final_norm"], x, cfg.norm), new_caches

    def logits(self, W: Params, h: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        if self.cfg.tie_embeddings:
            return h @ W["embed"].to(dt).T
        return h @ W["lm_head"].to(dt)

    def forward(self, W: Params, batch: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.float32):
        """Full-sequence logits over the parameter tree ``W`` (this model's
        layout; the layers cast matrices to ``dtype`` at use).  Autograd
        flows to ``W``'s leaves; ``aux`` is empty for the dense family."""
        h, _ = self._backbone(W, batch, None, None, dtype)
        return self.logits(W, h), {}

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
        cfg = self.cfg
        return {"blocks": [L.init_attn_cache(cfg, batch_size, max_len,
                                             window=cfg.sliding_window,
                                             dtype=dtype, device=self.device)
                           for _ in range(cfg.n_layers)],
                "pos": torch.zeros((batch_size,), dtype=torch.int32,
                                   device=self.device)}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Params,
                dtype: torch.dtype = torch.bfloat16):
        W = self.weights(dtype)
        batch = dict(batch, start_pos=cache["pos"])
        h, new_blocks = self._backbone(W, batch, cache["blocks"],
                                       cache["pos"], dtype)
        s = batch["tokens"].shape[1]
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + s}

    def decode_step(self, tokens: torch.Tensor, cache: Params,
                    dtype: torch.dtype = torch.bfloat16):
        """tokens: (B,) int."""
        W = self.weights(dtype)
        batch = {"tokens": tokens[:, None], "start_pos": cache["pos"]}
        h, new_blocks = self._backbone(W, batch, cache["blocks"],
                                       cache["pos"], dtype)
        return self.logits(W, h[:, -1]), {"blocks": new_blocks,
                                          "pos": cache["pos"] + 1}


def build_model(cfg: ArchConfig, device=None, seed: Optional[int] = 0
                ) -> Model:
    return Model(cfg, device=device, seed=seed)
