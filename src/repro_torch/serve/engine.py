"""Batched serving engine: prefill once, then one decode step per token.

The port of the JAX package's ``serve/engine.py``.  ``Engine`` wraps a
``Model`` with sampling and cache management; the key chain and the draws
are the JAX package's (``repro_torch.utils.prng``), so the same seed and
logits sample the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> no truncation
    cache_dtype: torch.dtype = torch.float32
    seed: int = 0


def sample_logits(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float, top_k: int) -> torch.Tensor:
    """logits: (B, V) (audio: (B, C, V)); returns int32 token ids, (B,)
    (audio: (B, C))."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    return prng.categorical(key, scaled, axis=-1).to(torch.int32)


class Engine:
    def __init__(self, model: Model, sc: ServeConfig):
        self.model = model
        self.sc = sc

    def _decode_body(self, tokens, cache, key):
        logits, cache = self.model.decode_step(tokens, cache,
                                               dtype=self.sc.cache_dtype)
        key, sub = prng.split(key)
        nxt = sample_logits(logits, sub, self.sc.temperature, self.sc.top_k)
        return nxt, cache, key, logits

    def generate(self, batch: Dict[str, torch.Tensor],
                 n_new: Optional[int] = None, return_logits: bool = False):
        """Prefill the prompt batch and decode n_new tokens.

        The batch is the model family's: ``tokens`` (B, S) (audio: (B, S,
        C) codebook frames), and for vlm ``image_embeds`` (B, P, D), the
        prefix the prompt's cache slots start with.  Returns generated ids
        (B, n_new) (audio: (B, n_new, C)) as numpy; with ``return_logits``
        also the (B, n_new, V) (audio: (B, n_new, C, V)) logits each token
        was drawn from."""
        sc = self.sc
        n_new = n_new or sc.max_new_tokens
        bsz, s = batch["tokens"].shape[:2]
        if "image_embeds" in batch:
            s += batch["image_embeds"].shape[1]
        if s + n_new - 1 > sc.max_len:
            raise ValueError(f"prompt {s} + {n_new} new tokens need "
                             f"{s + n_new - 1} cache slots; max_len is "
                             f"{sc.max_len}")
        cache = self.model.init_cache(bsz, sc.max_len, dtype=sc.cache_dtype)
        logits, cache = self.model.prefill(batch, cache,
                                           dtype=sc.cache_dtype)
        key = prng.PRNGKey(sc.seed, device=logits.device)
        key, sub = prng.split(key)
        tok = sample_logits(logits, sub, sc.temperature, sc.top_k)
        toks: List[torch.Tensor] = [tok]
        seen: List[torch.Tensor] = [logits]
        for _ in range(n_new - 1):
            tok, cache, key, logits = self._decode_body(tok, cache, key)
            toks.append(tok)
            seen.append(logits)
        out = np.stack([t.cpu().numpy() for t in toks], axis=1)
        if return_logits:
            return out, torch.stack(seen, dim=1)
        return out
