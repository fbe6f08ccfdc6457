"""Wrapper of the Hopper decode attention kernel
(``csrc/decode_attention.cu``).

``decode_attention`` is the counterpart of the JAX package's Pallas call
(``repro/kernels/decode_attention/decode_attention.py``) in the cache layout
of its GQA wrapper: q (B, H, D) and the cache k, v (B, T, Hkv, D), read in
place up to each row's length.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ref.decode_attention_ref``).  A call launches
two kernels, the split phase and the merge (``split_plan`` picks the
chunk), and adds one to ``COUNTS["decode_attention"]``.  With
``return_lse`` the merge also writes each row's log-sum-exp, so that calls
over disjoint slices of one cache merge exactly (``ref.merge_slices``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_operand, load
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import (DTYPES,
                                                                  HEAD_DIMS)

#: launches of the kernel since the last ``reset_counts``
COUNTS = {"decode_attention": 0}
_ERR_SHARED_MEMORY = -2
#: cache slots per TMA tile; a chunk is a multiple of it
TILE = 64
#: the largest chunk (its scores sit in shared memory)
MAX_CHUNK = 512
#: blocks of the split phase per SM the chunk is chosen for
BLOCKS_PER_SM = 2
#: SM count of each device index, read once
_SMS = {}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = ([P] * 7 + [I] * 7 + [ctypes.c_float]
                                         + [I, P])
    lib.decode_attention_fwd.restype = I
    lib.decode_attention_shared_bytes.argtypes = [I, I, I, I]
    lib.decode_attention_shared_bytes.restype = ctypes.c_longlong


def split_plan(t: int, b: int, hkv: int, sms: int = 132) -> int:
    """Cache slots per chunk of the split phase: the largest multiple of
    ``TILE`` (at most ``MAX_CHUNK``) that still gives the grid of
    ``b * hkv * ceil(t / chunk)`` blocks ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs.  Depends on shapes only, never on the lengths, so a decode
    step does not synchronise."""
    splits = max(1, -(-BLOCKS_PER_SM * sms // max(1, b * hkv)))
    per_split = -(-t // splits)
    return min(MAX_CHUNK, TILE * max(1, per_split // TILE))


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, return_lse: bool = False):
    """One query token per row: q (B, H, D) over the cache k, v
    (B, T, Hkv, D), slots t < lengths[b] (int, (B,)); f32 or bf16 in, the
    same dtype out.  Returns (B, H, D); with ``return_lse`` also each row's
    log-sum-exp of its scaled scores (f32, (B, H); -inf for a row with no
    live slot, whose output is 0)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and k (B, T, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    dtypes = (q.dtype,) if q.dtype in DTYPES else tuple(DTYPES)
    check_operand("q", q, (b, h, d), dtypes, q.device)
    for name, x in (("k", k), ("v", v)):
        check_operand(name, x, (b, t, hkv, d), dtypes, q.device, align=16)
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths must be int32 or int64, got "
                        f"{lengths.dtype}")
    lengths = lengths.to(torch.int32).contiguous()
    check_operand("lengths", lengths, (b,), (torch.int32,), q.device)
    out = torch.empty_like(q)
    dev = q.device
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    chunk = split_plan(t, b, hkv, _sm_count(dev))
    n_split = max(1, -(-t // chunk))
    partials = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                           device=dev)
    lib = load("decode_attention", _bind)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), partials.data_ptr(),
        None if lse is None else lse.data_ptr(), b, t, h, hkv, d,
        DTYPES[q.dtype], chunk, 1.0 / d ** 0.5, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == _ERR_SHARED_MEMORY:
        need = lib.decode_attention_shared_bytes(h // hkv, d, chunk,
                                                 DTYPES[q.dtype])
        raise ValueError(
            f"decode kernel needs {need} bytes of shared memory per block at "
            f"{h // hkv} query heads per kv head, head_dim {d}, chunk "
            f"{chunk}; the device allows less")
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"error {rc}")
    COUNTS["decode_attention"] += 1
    return (out, lse) if return_lse else out
