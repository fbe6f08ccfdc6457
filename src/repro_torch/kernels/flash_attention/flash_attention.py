"""Wrapper of the Hopper flash attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` is the counterpart of the JAX package's Pallas call
(``repro/kernels/flash_attention/flash_attention.py``) in the layout of its
GQA wrapper: q (B, S, H, D) and k, v (B, S, Hkv, D), read in place.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ref.attention_ref``).  bf16 at head_dim 64,
128 and 256 runs on the tensor cores (wgmma fed by TMA); f32, and bf16 at
head_dim 32 and 112, on the CUDA cores (``design``).  Each launch adds one to
``COUNTS["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import check_operand, load
from repro_torch.kernels.flash_attention.ref import attention_ref

#: launches of the kernel since the last ``reset_counts``
COUNTS = {"flash_attention": 0}
#: head dims and dtypes the kernel is built for (dtype -> its C code)
HEAD_DIMS = (32, 64, 112, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the bf16 tensor-core kernel
WGMMA_HEAD_DIMS = (64, 128, 256)


def design(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a call of this dtype and head_dim launches."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma+tma"
    return "cuda-core"


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = ([P] * 4 + [I] * 8 + [ctypes.c_float]
                                        + [I, P])
    lib.flash_attention_fwd.restype = I
    lib.flash_attention_shared_bytes.argtypes = [I, I]
    lib.flash_attention_shared_bytes.restype = ctypes.c_longlong


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k, v (B, S, Hkv, D), H a multiple
    of Hkv; f32 or bf16 in, the same dtype out.  ``causal``: key <= query;
    ``window`` w: key > query - w.  Returns (B, S, H, D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, S, H, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not share {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    dtypes = (q.dtype,) if q.dtype in DTYPES else tuple(DTYPES)
    check_operand("q", q, (b, s, h, d), dtypes, q.device, align=16)
    for name, t in (("k", k), ("v", v)):
        check_operand(name, t, (b, s, hkv, d), dtypes, q.device, align=16)
    out = torch.empty_like(q)
    dev = q.device
    rc = load("flash_attention", _bind).flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        hkv, d, DTYPES[q.dtype], int(causal), window or 0, 1.0 / d ** 0.5,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"error {rc}")
    COUNTS["flash_attention"] += 1
    return out
