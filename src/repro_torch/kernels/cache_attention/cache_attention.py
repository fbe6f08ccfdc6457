"""Wrapper of the Hopper cache attention kernel (``csrc/cache_attention.cu``).

``cache_attention`` is the counterpart of the JAX package's plain-jnp read
over a KV cache (``repro/models/layers.py::attention_apply``'s cached
branch, through ``grouped_attention`` and ``chunked_grouped_attention``):
S queries over every slot of the cache, each slot masked by the position
it holds.  The JAX package has no Pallas kernel there; the port runs it
through this one.  q (B, S, H, D) and the cache k, v (B, T, Hkv, D) are
read in place, with q_pos (B, S) and k_pos (B, T).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ref.cache_attention_ref``).  bf16 at head_dim
64, 112, 128 and 256 runs on the tensor cores (wgmma fed by TMA), f32, and
bf16 at head_dim 32, on the CUDA cores (``design``), as flash attention
chooses.  A call adds one to ``COUNTS["cache_attention"]``; it launches the
kernel, and where ``split_plan`` cuts the slots into chunks, a merge.  With
``return_lse`` it also returns each row's log-sum-exp, so that calls over
disjoint slices of one cache merge exactly
(``decode_attention.merge_weights``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import check_operand, load
from repro_torch.kernels.cache_attention.ref import cache_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPES, HEAD_DIMS, WGMMA_HEAD_DIMS)

#: launches of the kernel since the last ``reset_counts``
COUNTS = {"cache_attention": 0}
_ERR_SHARED_MEMORY = -2
#: SM count of each device index, read once
_SMS = {}


class Tiles(NamedTuple):
    """A design's grid at one (dtype, head_dim), as the source builds it:
    rows a block, cache slots a tile (a chunk is a multiple of it), blocks
    an SM, and whether a block's rows are (query, head) pairs of one kv
    head's group (else queries of one query head)."""
    rows: int
    keys: int
    blocks_per_sm: int
    grouped: bool


def design(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a call of this dtype and head_dim launches."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma+tma"
    return "cuda-core"


def tiles(dtype: torch.dtype, d: int) -> Tiles:
    """The grid of ``design(dtype, d)`` (the source's ``TcShape<D>`` and
    ``CcShape<T, D>``)."""
    if design(dtype, d) == "wgmma+tma":
        return Tiles(128, 128 if d in (112, 128) else 64, 1, False)
    return Tiles(128 if d <= 32 else 32 if d == 112 else 64,
                 64 if d <= 128 else 32, 2 if d in (64, 112) else 1, True)


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cache_attention_fwd.argtypes = [P] * 8 + [I] * 10 + [P]
    lib.cache_attention_fwd.restype = I
    lib.cache_attention_shared_bytes.argtypes = [I, I]
    lib.cache_attention_shared_bytes.restype = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def split_plan(b: int, s: int, h: int, hkv: int, t: int, d: int,
               dtype: torch.dtype, sms: int = 132) -> int:
    """Cache slots a block takes, a multiple of the design's slot tile:
    the chunk whose grid finishes first in a model of whole waves,
    ceil(blocks x splits / (blocks an SM x sms)) waves of chunk / tile
    tiles each; a tie goes to fewer splits (each costs a merge).  Splits
    are tried only while the grid has under two waves.  Depends on shapes
    only."""
    tl = tiles(dtype, d)
    g = h // max(1, hkv)
    blocks = max(1, b * (hkv * -(-s * g // tl.rows) if tl.grouped
                         else h * -(-s // tl.rows)))
    n_tiles = -(-t // tl.keys)
    slots = tl.blocks_per_sm * sms
    best = None
    for n in range(1, max(1, min(n_tiles, -(-2 * slots // blocks))) + 1):
        per = -(-n_tiles // n)                  # tiles a chunk
        waves = -(-blocks * -(-n_tiles // per) // slots)
        if best is None or waves * per < best[0]:
            best = (waves * per, per)
    return tl.keys * best[1]


def shared_bytes(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory a block of ``design(dtype, d)`` asks for (the
    source's ``cache_attention_shared_bytes``).  wgmma: the Q tile and a
    ring of K and V stages in 128-byte swizzle atoms with each tile's k_pos
    and their range, the mbarriers and 1,024 bytes of alignment slack;
    CUDA cores: Q^T in f32, two K stages (rows padded by 16 bytes but at
    112), one V stage (two, and a P tile, but at 64 and 112) and two k_pos
    stages."""
    tl = tiles(dtype, d)
    if design(dtype, d) == "wgmma+tma":
        atoms = -(-d // 64)
        stages = 3 if atoms <= 2 else 2
        return (1024 + atoms * tl.rows * 128 + 2 * stages * atoms * tl.keys
                * 128 + stages * 4 * (tl.keys + 4) + 8 * (1 + 3 * stages))
    es = 4 if dtype == torch.float32 else 2
    lean = d in (64, 112)
    ldk = d if d == 112 else d + 16 // es
    return (4 * d * tl.rows + 2 * es * tl.keys * ldk
            + (1 if lean else 2) * es * tl.keys * d
            + (0 if lean else 4 * tl.rows * (tl.keys + 4)) + 8 * tl.keys)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int] = None, return_lse: bool = False):
    """S queries q (B, S, H, D) at positions q_pos (B, S) over the whole
    cache k, v (B, T, Hkv, D) holding positions k_pos (B, T) (int32; -1
    where not written): slot t is live for query i where k_pos >= 0, k_pos
    <= q_pos and, with a window, k_pos > q_pos - window.  f32 or bf16 in,
    the same dtype out.  A query with no live slot gets the mean of V over
    the T slots (the JAX package's finite mask).  Returns (B, S, H, D);
    with ``return_lse`` also each row's log-sum-exp of its live scaled
    scores (f32, (B, S, H); -inf where none is live)."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return cache_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                   return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"cache_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D) and k (B, T, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} kv heads")
    if t == 0:
        raise ValueError("the cache has no slot")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    dtypes = (q.dtype,) if q.dtype in DTYPES else tuple(DTYPES)
    dev = q.device
    check_operand("q", q, (b, s, h, d), dtypes, dev, align=16)
    for name, x in (("k", k), ("v", v)):
        check_operand(name, x, (b, t, hkv, d), dtypes, dev, align=16)
    check_operand("q_pos", q_pos, (b, s), (torch.int32,), dev)
    check_operand("k_pos", k_pos, (b, t), (torch.int32,), dev)
    out = torch.empty_like(q)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    chunk = split_plan(b, s, h, hkv, t, d, q.dtype, _sm_count(dev))
    n_split = -(-t // chunk)
    partials = (torch.empty(b * s * h * n_split * (d + 2),
                            dtype=torch.float32, device=dev)
                if n_split > 1 else None)
    lib = load("cache_attention", _bind)
    rc = lib.cache_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, t, h, hkv, d,
        DTYPES[q.dtype], window or 0, chunk, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == _ERR_SHARED_MEMORY:
        raise ValueError(f"cache attention at head_dim {d} needs more shared "
                         f"memory per block than the device allows")
    if rc != 0:
        raise RuntimeError(f"cache attention kernel launch failed: error "
                           f"{rc}")
    COUNTS["cache_attention"] += 1
    return (out, lse) if return_lse else out
