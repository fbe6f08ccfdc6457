"""Synthetic LM token pipeline (no downloaded corpora).

The port's own copy of the JAX package's ``repro.data.tokens`` (numpy
only; the port imports nothing of the JAX package), so its batches equal
the JAX stream's bit for bit.  A deterministic Zipf-distributed Markov
token stream with enough structure for loss curves to move (bigram
coupling), plus batch iterators that yield exactly the model-family batch
dicts (dense tokens / audio codebooks / vlm text + image-embedding
prefixes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Deterministic structured synthetic corpus."""

    def __init__(self, cfg: ArchConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        self.rng = np.random.default_rng(dc.seed)
        v = cfg.vocab_size
        # Zipf marginal over a capped alphabet for tractable sampling
        self.alphabet = min(v, 32_768)
        ranks = np.arange(1, self.alphabet + 1, dtype=np.float64)
        p = ranks ** (-dc.zipf_a)
        self.marginal = p / p.sum()
        # bigram structure: each token prefers a pseudo-random successor set
        self.shift = self.rng.integers(1, self.alphabet - 1)

    def _sample_tokens(self, shape) -> np.ndarray:
        base = self.rng.choice(self.alphabet, size=shape, p=self.marginal)
        # half the positions follow the deterministic successor rule
        follow = self.rng.random(shape) < 0.5
        succ = (np.roll(base, 1, axis=-1) + self.shift) % self.alphabet
        out = np.where(follow, succ, base)
        out[..., 0] = base[..., 0]
        return out.astype(np.int32)

    def batches(self, n_batches: int | None = None,
                ) -> Iterator[Dict[str, np.ndarray]]:
        cfg, dc = self.cfg, self.dc
        i = 0
        while n_batches is None or i < n_batches:
            if cfg.family == "audio":
                toks = self._sample_tokens(
                    (dc.batch_size, dc.seq_len, cfg.n_codebooks))
                toks = np.minimum(toks, cfg.vocab_size - 1)
                yield {"tokens": toks}
            elif cfg.family == "vlm":
                p = min(cfg.frontend_tokens, dc.seq_len - 1)
                toks = self._sample_tokens((dc.batch_size, dc.seq_len - p))
                toks = np.minimum(toks, cfg.vocab_size - 1)
                img = self.rng.standard_normal(
                    (dc.batch_size, p, cfg.d_model)).astype(np.float32)
                yield {"tokens": toks, "image_embeds": img}
            else:
                toks = self._sample_tokens((dc.batch_size, dc.seq_len))
                toks = np.minimum(toks, cfg.vocab_size - 1)
                yield {"tokens": toks}
            i += 1
