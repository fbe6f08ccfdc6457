"""Wrapper of the Hopper SDCA kernel (``csrc/sdca.cu``).

``sdca_local_solve`` is the counterpart of the JAX package's Pallas call of
the same name (``repro/kernels/sdca/sdca.py``): the batched hinge-SDCA local
solve, one task per thread block.  The chunk plan (residual mode, chunk
width) comes from ``repro_torch.core.subproblem``, as the plain version's
does; the kernel pads the stream's last chunk (``chunk_idx_stream``'s
layout) and clamps the budgets to ``max_steps`` itself.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (``ref.sdca_ref``).  Each launch adds one to
``COUNTS["sdca_local_solve"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.subproblem import _solver_plan, row_norms
from repro_torch.kernels.build import check_operand, load
from repro_torch.kernels.sdca.ref import sdca_ref

#: launches of the kernel since the last ``reset_counts``
COUNTS = {"sdca_local_solve": 0}
#: what the kernel's entry point returns when a block needs more shared
#: memory than the device allows
_ERR_SHARED_MEMORY = -1
_GRAM_LANES = 32   # gram mode runs a chunk's steps on one warp


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sdca_local_solve.argtypes = [P] * 11 + [I] * 7 + [P]
    lib.sdca_local_solve.restype = I
    lib.sdca_shared_bytes.argtypes = [I] * 5
    lib.sdca_shared_bytes.restype = ctypes.c_longlong
    lib.sdca_shared_limit.argtypes = [I]
    lib.sdca_shared_limit.restype = ctypes.c_longlong


def sdca_local_solve(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     alpha: torch.Tensor, W: torch.Tensor,
                     q_t: torch.Tensor, budgets: torch.Tensor,
                     idx: torch.Tensor, max_steps: int,
                     gram: Optional[bool] = None,
                     xnorm2: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched hinge-SDCA local solve.

    X (m, n, d) f32; y, mask, alpha (m, n) f32; W (m, d) f32; q_t (m,) f32;
    budgets (m,) int; idx (m, max_steps) int coordinate streams.  ``gram``
    overrides the residual-mode rule; ``xnorm2`` (m, n) takes the per-run
    row-norm table.  Returns (dalpha (m, n), u (m, d)).
    """
    if X.device.type == "cpu":
        return sdca_ref(X, y, mask, alpha, W, q_t, budgets, idx, gram=gram,
                        xnorm2=xnorm2)
    if X.device.type != "cuda":
        raise ValueError(f"sdca_local_solve runs on cuda or cpu, got "
                         f"{X.device}")
    if X.dim() != 3:
        raise ValueError(f"X must be (m, n, d), got {tuple(X.shape)}")
    m, n, d = X.shape
    dev, f32 = X.device, torch.float32
    if xnorm2 is None:
        xnorm2 = row_norms(X)
    for name, t, shape in (("X", X, (m, n, d)), ("y", y, (m, n)),
                           ("mask", mask, (m, n)), ("alpha", alpha, (m, n)),
                           ("W", W, (m, d)), ("q_t", q_t, (m,)),
                           ("xnorm2", xnorm2, (m, n))):
        check_operand(name, t, shape, (f32,), dev)
    for name, t, shape in (("budgets", budgets, (m,)),
                           ("idx", idx, (m, max_steps))):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
        check_operand(name, t, shape, (t.dtype,), dev)
    gram, C = _solver_plan(d, max_steps, gram)
    if gram and C > _GRAM_LANES:
        raise ValueError(f"gram mode takes chunks of at most {_GRAM_LANES}")
    # the kernel clamps the budgets to max_steps and pads the last chunk
    # (chunk_idx_stream's layout) itself: the padded steps are dead
    budgets = budgets.to(torch.int32)
    idx_c = idx.to(torch.int32)
    dalpha = torch.empty((m, n), dtype=f32, device=dev)
    u = torch.empty((m, d), dtype=f32, device=dev)

    lib = load("sdca", _bind)
    rc = lib.sdca_local_solve(
        X.data_ptr(), y.data_ptr(), mask.data_ptr(), alpha.data_ptr(),
        W.data_ptr(), xnorm2.data_ptr(), idx_c.data_ptr(), q_t.data_ptr(),
        budgets.data_ptr(), dalpha.data_ptr(), u.data_ptr(),
        m, n, d, max_steps, C, int(gram), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == _ERR_SHARED_MEMORY:
        nbytes = lib.sdca_shared_bytes(n, d, C, int(gram), dev.index)
        raise ValueError(
            f"SDCA kernel needs {nbytes} bytes of shared memory per block at "
            f"n={n}, d={d}, C={C}; the device allows "
            f"{lib.sdca_shared_limit(dev.index)}")
    if rc != 0:
        raise RuntimeError(f"SDCA kernel launch failed: CUDA error {rc}")
    COUNTS["sdca_local_solve"] += 1
    return dalpha, u
