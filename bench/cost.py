"""Operations and bytes of a MOCHA round, counted from shapes and budgets.

``solve_cost`` is a frozen copy of ``bound()`` in ``chip_smoke.py``
(lines 1682-1714 when it was copied): the SDCA local solve's bytes, each
input read once and each output written once, and its float32 operations
over the chunks that the budgets make live.  The chunk plan it counts by
is the program's (``_solver_plan`` in
``src/repro_torch/core/subproblem.py``, lines 49-82): gram mode up to
d = 128 with chunks of 32 steps, carry mode above with chunks of 64 steps
from d = 512 and of 16 below.

``round_flops`` and ``omega_flops`` extend it to the rest of a round's
useful work, which ``round_mfu`` counts: W(alpha) = K V / 2 every round,
and the probabilistic regularizer's Omega step.
"""
from __future__ import annotations

import numpy as np

GRAM_MAX_D = 128
GRAM_CHUNK = 32
CARRY_CHUNK_WIDE, CARRY_CHUNK_NARROW, CARRY_WIDE_D = 64, 16, 512


def plan(d: int, max_steps: int):
    """(gram?, chunk) of the solve at feature count d."""
    gram = d <= GRAM_MAX_D
    if gram:
        C = GRAM_CHUNK
    else:
        C = CARRY_CHUNK_WIDE if d >= CARRY_WIDE_D else CARRY_CHUNK_NARROW
    return gram, max(1, min(C, max_steps))


def solve_cost(m: int, n: int, d: int, max_steps: int, budgets) -> dict:
    """One round's local solve over m tasks of n padded points and d
    features, each task running its budget (``budgets``, (m,) steps)."""
    gram, C = plan(d, max_steps)
    n_chunks = -(-max_steps // C)
    nbytes = 4 * (m * n * d + 4 * m * n + m * d + m * n_chunks * C + 2 * m
                  + m * n + m * d)
    live = (np.minimum(np.asarray(budgets, np.int64), max_steps) + C - 1) // C
    if gram:   # G_c, p_c, C steps of O(C), column sum, r and u updates
        per_chunk = 2 * C * C * d + 2 * C * d + C * (2 * C + 12) \
            + 2 * C * d + 3 * d
    else:      # C steps of dot + axpy, column sum, u update
        per_chunk = C * (4 * d + 12) + 2 * C * d + d
    return dict(bytes=int(nbytes), flops=int(live.sum()) * per_chunk,
                mode="gram" if gram else "carry", chunk=C,
                chain_steps=int(live.max()) * C)


def round_flops(cells: int, m: int, d: int) -> int:
    """W(alpha) = K V / 2 of every cell: an (m, m) by (m, d) product and
    the halving."""
    return cells * (2 * m * m * d + m * d)


def omega_flops(cells: int, m: int, d: int) -> int:
    """One Omega step of every cell: W(alpha) (2 m^2 d + m d), W W^T
    (2 m^2 d), the square root by an eigendecomposition (9 m^3) and its
    product back (2 m^3), the trace and the division (2 m^2); then the
    coupling: Omega's inverse the same way (11 m^3), Abar (3 m^2), K = Abar^-1
    (2 m^3) and sigma'_t, q_t (3 m^2)."""
    return cells * (4 * m * m * d + m * d + 24 * m ** 3 + 8 * m * m)
