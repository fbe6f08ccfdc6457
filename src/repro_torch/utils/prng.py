"""JAX's ``threefry2x32`` PRNG in torch integer ops, bit for bit.

Every random number of a MOCHA run (the driver's key chain, the per-task
key split, the SDCA coordinate draws, the budget draws) and of LM sampling
comes from this generator, so a port run draws exactly the coordinates,
budgets and sampled tokens the JAX package draws from the same seed, and
whole runs compare round by round.

The layout is JAX's ``jax_threefry_partitionable=True`` one: ``split`` and
``random_bits`` hash a 64-bit iota (high word 0 here) under the key, and
32-bit random bits are the XOR of the hash's two output words.  A key is an
int64 tensor of shape ``(..., 2)`` holding two uint32 words; leading
dimensions batch keys the way ``vmap`` over keys would.  Torch has no
``<<`` on uint32 on the CPU, so the words live in int64 and every add and
shift is masked back to 32 bits.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): a uint32
    seed, as the cohort loop's per-block seeds are."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counts (x1, x2) under (k1, k2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    """Hash the iota of ``shape`` under every key of the batch ``key``."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise NotImplementedError("random bits beyond 2**32 elements")
    batch = key.shape[:-1]
    expand = batch + (1,) * len(shape)
    k1 = key[..., 0].reshape(expand)
    k2 = key[..., 1].reshape(expand)
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    lo = lo.reshape(shape)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``key.shape[:-1] + (num, 2)`` new keys."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, in int64, shape ``batch + shape``."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32:
    ``max(minval, u * (maxval - minval) + minval)`` for u on [0, 1), the
    multiply-add rounded once as XLA fuses it (float64 holds the product of
    two float32 exactly)."""
    bits = (random_bits(key, shape) >> 9) | _ONE_F32_BITS
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:   # the same bits, fewer launches
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    width = torch.tensor(maxval, dtype=torch.float32, device=u.device) - lo
    return torch.maximum(lo, (u.double() * width.double()
                              + lo.double()).float())


def bernoulli(key: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform below float32 p."""
    u = uniform(key, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (its default "low"
    mode): ``-log(-log(u))`` for u uniform on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max draw
    ``argmax(logits + gumbel)``, token-equal to JAX's for the same key and
    float32 logits."""
    g = gumbel(key, logits.shape).to(logits.device)
    return torch.argmax(g + logits, dim=axis)
