"""The SDCA kernel's plain PyTorch version (hinge loss).

It delegates to the port's solver, ``repro_torch.core.subproblem``, so the
kernel is held against the same arithmetic the local engine runs.  The
wrapper (``sdca.sdca_local_solve``) takes it for tensors on the CPU, and
``chip_smoke.py`` compares the kernel with it on the card.
"""
from __future__ import annotations

from repro_torch.core.losses import HINGE
from repro_torch.core.subproblem import batched_local_sdca_idx


def sdca_ref(X, y, mask, alpha, W, q_t, budgets, idx, gram=None,
             xnorm2=None):
    """Batched hinge-SDCA over explicit coordinate streams idx (m, steps)."""
    return batched_local_sdca_idx(HINGE, X, y, mask, alpha, W, q_t, budgets,
                                  idx, idx.shape[-1], xnorm2, gram)
