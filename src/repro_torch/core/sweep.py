"""Batched hyperparameter sweep over the pre-sampled MOCHA driver.

Table-1/4 evaluation is a (shuffle x regularizer) grid of otherwise
identical MOCHA runs.  The JAX package vmaps its scanned driver twice; the
port writes the cell axis out.  The R x S cells, m tasks each, are one
batch of R*S*m tasks: one round of the whole grid is the local engine's
round over every cell's tasks (the per-task solve depends only on its W
row, q_t, budget and key; K and the round keys carry the cell axis), run
through the pre-sampled driver's ``RoundProgram`` and segment loop, so on
the card a round of the grid is one CUDA graph replay.

Constraints (checked): the regularizers are of one dataclass type and the
fields that vary across the grid are numeric; no ``budget_fn``; the local
engine.  The Omega refresh runs per cell between two rounds, outside the
graph, since a regularizer's Omega step may read the host (``Clustered``'s
bisection); the new K and q_t of every cell are then copied into the
program's buffers.

Systems clocks: the semi_sync deadline caps are a pure function of the
``SystemsConfig`` (``presample_policy_caps``), so one (rounds, m) cap
matrix serves every cell, folded into the pre-sampled budgets exactly as
the single run folds its own.  The sweep measures statistics, not time: no
trace is replayed.

Devices: the grid runs whole on one device.  ``_shard_grid`` holds the JAX
package's rule for spreading its independent cells over several; the port
does not apply it yet, since each slice would capture and replay the whole
round's launches from the one host (ROADMAP item 20).

Shuffles with different ``n_max`` are right-padded to a common size by
``stack_federations``.  A padded cell solves the same problem as the
unpadded single run from the same draws: a coordinate draw does not depend
on the stream's length (threefry's counter layout), padded points are never
drawn or counted, and the longer stream's extra chunks are dead.  Sums over
the longer point axis round differently, so the two agree to float32
rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core.dual import DualState, FederatedData
from repro_torch.core.engine import _scan_local_round, get_engine
from repro_torch.core.evaluate import evaluate_grid
from repro_torch.core.losses import HINGE, get_loss
from repro_torch.core.mocha import (MochaConfig, _coupling_terms, _metrics,
                                    _replay_rounds, _round_program,
                                    presample_round_inputs)
from repro_torch.core.regularizers import Regularizer
from repro_torch.core.subproblem import resolve_gram
from repro_torch.core.systems_model import presample_policy_caps
from repro_torch.core.theta import validate_assumption2
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class SweepResult:
    """Grid-shaped results: axis 0 = regularizer grid, axis 1 = shuffles."""

    W: np.ndarray        # (R, S, m, d) final per-task models
    omega: np.ndarray    # (R, S, m, m)
    dual: np.ndarray     # (R, S) final dual objective
    primal: np.ndarray   # (R, S) final primal objective
    gap: np.ndarray      # (R, S) final duality gap
    regs: Tuple[Regularizer, ...]
    seeds: Tuple[int, ...]
    #: host seconds spent on the grid round's CUDA graph (warm-up round,
    #: capture, instantiation); None where none was captured
    capture_s: Optional[float] = None


def stack_federations(datas: Sequence[FederatedData]) -> FederatedData:
    """Stack federations (shuffles) into one (S, m, n, d) FederatedData.

    Right-pads each shuffle's point axis to the common ``n_max`` (padding
    has mask 0 and is inert everywhere).  All shuffles must share (m, d).
    """
    if not datas:
        raise ValueError("stack_federations needs at least one federation")
    m, d = datas[0].m, datas[0].d
    for f in datas:
        if (f.m, f.d) != (m, d):
            raise ValueError(
                f"cannot stack federations of shape (m={f.m}, d={f.d}) with "
                f"(m={m}, d={d})")
    n_max = max(f.n_max for f in datas)

    def pad(a, width):
        # pad the point axis (1) of (m, n) or (m, n, d)
        return torch.nn.functional.pad(
            a, (0, 0, 0, width) if a.dim() == 3 else (0, width))

    return FederatedData(
        X=torch.stack([pad(f.X, n_max - f.n_max) for f in datas]),
        y=torch.stack([pad(f.y, n_max - f.n_max) for f in datas]),
        mask=torch.stack([pad(f.mask, n_max - f.n_max) for f in datas]),
    )


def grid_batch_reason(regs: Sequence[Regularizer]) -> Optional[str]:
    """Why a regularizer grid cannot be batched (None = it can): the JAX
    package's test and words, which the router records as the grid path's
    fallback reason.  The port batches the regularizer objects themselves,
    so a varying numeric field needs no traced stand-in."""
    template = regs[0]
    for r in regs:
        if type(r) is not type(template):
            return (f"mixed regularizer types ({type(template).__name__} vs "
                    f"{type(r).__name__}) cannot become one traced template")
    for f in dataclasses.fields(template):
        vals = [getattr(r, f.name) for r in regs]
        if any(v != vals[0] for v in vals):
            if not all(isinstance(v, (float, int)) and not isinstance(v, bool)
                       for v in vals):
                return (f"grid field {f.name!r} is not numeric and cannot "
                        "become a traced scalar")
    return None


def _shard_grid(n_regs: int, n_shuffles: int,
                n_devices: int) -> Tuple[Optional[str], int]:
    """How the grid's cells would spread over ``n_devices``: ``(axis,
    k)``, the ``"shuffles"`` or ``"regs"`` axis cut in k equal slices, or
    ``(None, 1)`` (the grid stays whole).

    The JAX package's rule: per axis, the largest k in 2..n_devices that
    divides it; the axis with the larger k wins, ties go to the shuffles.
    """
    if n_devices <= 1:
        return None, 1
    k_shuffle = max((k for k in range(2, n_devices + 1)
                     if n_shuffles % k == 0), default=1)
    k_reg = max((k for k in range(2, n_devices + 1) if n_regs % k == 0),
                default=1)
    k = max(k_shuffle, k_reg)
    if k <= 1:
        return None, 1
    return ("shuffles" if k_shuffle >= k_reg else "regs"), k


def _run_sweep(data: Union[FederatedData, Sequence[FederatedData]],
               regs: Sequence[Regularizer],
               seeds: Union[int, Sequence[int]],
               cfg: MochaConfig) -> SweepResult:
    """Run the (regularizer-grid x shuffle) sweep as one batched program.

    ``data``: a stacked (S, m, n, d) FederatedData or a sequence of
    federations (stacked by ``stack_federations``).  ``regs``: the grid of
    same-type regularizers.  ``seeds``: the driver seed of each shuffle (a
    scalar broadcasts).  ``cfg``: the shared MochaConfig (its ``device``
    says where the grid runs).
    """
    if not isinstance(data, FederatedData):
        data = stack_federations(data)
    if data.X.dim() != 4:
        raise ValueError("the sweep expects stacked (S, m, n, d) data; got "
                         f"X of shape {tuple(data.X.shape)}")
    if get_engine(cfg.engine).name != "local":
        raise ValueError(
            f"the sweep batches the local engine only; "
            f"cfg.engine={cfg.engine!r} is not supported")
    validate_assumption2(cfg.budget)
    if not regs:
        raise ValueError("the sweep needs at least one regularizer")
    S, m, n, d = data.X.shape
    if isinstance(seeds, (int, np.integer)):
        seeds = (int(seeds),) * S
    seeds = tuple(int(s) for s in seeds)
    if len(seeds) != S:
        raise ValueError(f"{len(seeds)} seeds for {S} shuffles")
    reason = grid_batch_reason(regs)
    if reason is not None:
        raise TypeError(f"cannot batch this sweep: {reason}")

    dev = resolve_device(cfg.device)
    data = dual_mod.with_xnorm2(data.to(dev))
    loss = get_loss(cfg.loss)
    R, rounds, every = len(regs), cfg.rounds, cfg.omega_update_every
    cells, tasks = R * S, R * S * m
    max_steps = cfg.budget.max_steps(n)
    gram = resolve_gram(d, cfg.gram_max_d)
    caps = (None if cfg.systems is None else
            presample_policy_caps(m, d, cfg.systems, rounds))

    # keys and budgets per shuffle, shared by every regularizer of the grid
    per = [presample_round_inputs(cfg, prng.PRNGKey(seed, device=dev),
                                  data.n_t[s], max_steps, caps)
           for s, seed in enumerate(seeds)]
    round_keys = torch.stack([k for k, _ in per], 1)     # (rounds, S, 2)
    budgets = torch.stack([b for _, b in per], 1)        # (rounds, S, m)
    # cells in (regularizer, shuffle) order, each cell's m tasks together
    round_keys = round_keys[:, None].expand(rounds, R, S, 2).reshape(
        rounds, cells, 2)
    budgets = budgets[:, None].expand(rounds, R, S, m).reshape(rounds, tasks)

    def cells_of(a):   # (S, m, ...) -> (R*S*m, ...), materialised once
        return a[None].expand(R, *a.shape).reshape(tasks, *a.shape[2:])

    cells_data = FederatedData(*(cells_of(a) for a in data))

    omegas = [[reg.init_omega(m, device=dev) for _ in range(S)]
              for reg in regs]
    coupling = [[_coupling_terms(reg, om, cfg.gamma, cfg.per_task_sigma, m)
                 for om in row] for reg, row in zip(regs, omegas)]

    def stacked_coupling():
        K = torch.stack([c[1] for row in coupling for c in row])
        q_t = torch.cat([c[2] for row in coupling for c in row])
        return K, q_t

    def omega_step(v):   # per cell: an Omega step may read the host
        v = v.view(R, S, m, d)
        for r, reg in enumerate(regs):
            for s in range(S):
                W = dual_mod.primal_weights(coupling[r][s][1], v[r, s])
                omegas[r][s] = reg.update_omega(W, omegas[r][s])
                coupling[r][s] = _coupling_terms(
                    reg, omegas[r][s], cfg.gamma, cfg.per_task_sigma, m)
        return stacked_coupling()

    K, q_t = stacked_coupling()
    prog = _round_program(_scan_local_round, loss, max_steps, gram,
                          cells_data, dual_mod.init_state(cells_data),
                          cfg.gamma, round_keys[0], budgets[0], K, q_t)
    _replay_rounds(prog, round_keys, budgets, every, omega_step)

    alpha = prog.state[0].view(R, S, m, n)
    v = prog.state[1].view(R, S, m, d)
    W = torch.empty((R, S, m, d), dtype=data.X.dtype, device=dev)
    obj = torch.empty((R, S, 3), dtype=data.X.dtype, device=dev)
    for r in range(R):
        for s in range(S):
            abar_rs, K_rs, _ = coupling[r][s]
            W[r, s] = dual_mod.primal_weights(K_rs, v[r, s])
            data_s = FederatedData(*(a[s] for a in data))
            obj[r, s] = torch.stack(_metrics(
                loss, data_s, DualState(alpha[r, s], v[r, s]), abar_rs,
                K_rs))
    obj = obj.cpu().numpy()
    omega = torch.stack([torch.stack(row) for row in omegas])
    return SweepResult(W=W.cpu().numpy(), omega=omega.cpu().numpy(),
                       dual=obj[..., 0], primal=obj[..., 1], gap=obj[..., 2],
                       regs=tuple(regs), seeds=seeds,
                       capture_s=prog.capture_s)


def sweep_errors(result: Union[SweepResult, np.ndarray],
                 test: FederatedData) -> np.ndarray:
    """(R, S) mean per-task test error of every grid cell: ``evaluate_grid``'s
    ``grid``.

    ``test`` is the stacked (S, m, n, d) test split matching the sweep's
    shuffle axis; ``result`` is a SweepResult or a raw (R, S, m, d) W.
    """
    W = result.W if isinstance(result, SweepResult) else result
    return evaluate_grid(W, test, HINGE, ("error",)).grid
