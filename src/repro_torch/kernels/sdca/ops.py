"""The SDCA kernel as a drop-in local solver for the MOCHA round.

Draws the same coordinate streams as ``repro_torch.core.subproblem`` (so the
kernel engine and the local engine solve the same problem from the same
keys) and hands them to the kernel.
"""
from __future__ import annotations

from repro_torch.core.subproblem import draw_coordinates
from repro_torch.kernels.sdca.sdca import sdca_local_solve

__all__ = ["draw_coordinates", "kernel_local_sdca"]


def kernel_local_sdca(data, alpha, W, q_t, budgets, keys, max_steps,
                      gram=None):
    """Counterpart of ``subproblem.batched_local_sdca`` (hinge only)."""
    idx = draw_coordinates(keys, data.n_t, data.n_max, max_steps)
    return sdca_local_solve(data.X, data.y, data.mask, alpha, W, q_t,
                            budgets, idx, max_steps, gram=gram,
                            xnorm2=data.xnorm2)
