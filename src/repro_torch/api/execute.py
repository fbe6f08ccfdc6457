"""Experiment execution: route, run, evaluate, stamp provenance.

``run_experiment`` is the one function behind ``Experiment.run``.  The
single path is the core driver (``repro_torch.core.mocha``), the batched
grid is the sweep (``repro_torch.core.sweep``), and the grid fallback runs
the core driver cell by cell.  What lives here is the glue: seeds,
held-out evaluation and the provenance block.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api.report import Report
from repro_torch.api.router import RoutePlan, route
from repro_torch.api.specs import (Experiment, as_mocha_config,
                                   config_fingerprint)
from repro_torch.core import evaluate as eval_mod
from repro_torch.core.dual import FederatedData
from repro_torch.core.losses import get_loss
from repro_torch.core.mocha import _run_mocha
from repro_torch.core.subproblem import active_gram_max_d
from repro_torch.core.sweep import SweepResult, _run_sweep
from repro_torch.utils.device import resolve_device

_LOG = logging.getLogger("repro_torch.api")

Seed = Union[int, Sequence[int]]


def _provenance(exp: Experiment, plan: RoutePlan) -> Dict[str, Any]:
    dev = resolve_device(exp.exec.device)
    resolved = (exp.exec.gram_max_d if exp.exec.gram_max_d is not None
                else active_gram_max_d())
    return {
        "path": plan.path,
        "driver": plan.driver,
        "engine": plan.engine,
        "fallback_reason": plan.reason,
        "gram_max_d": int(resolved),
        "gram_mode": "gram" if exp.problem.d <= int(resolved) else "carry",
        "config_hash": config_fingerprint(exp),
        "backend": dev.type,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
        "retries": None,
        "degraded_blocks": None,
        "telemetry": None,
        "trace_path": None,
    }


def _scalar_seed(seed: Seed) -> int:
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    raise ValueError(
        "this experiment runs a single problem; pass one integer seed "
        f"(got {seed!r})")


def _shuffle_seeds(seed: Seed, n_shuffles: int) -> Tuple[int, ...]:
    if isinstance(seed, (int, np.integer)):
        return (int(seed),) * n_shuffles
    seeds = tuple(int(s) for s in seed)
    if len(seeds) != n_shuffles:
        raise ValueError(f"{len(seeds)} seeds for {n_shuffles} shuffles")
    return seeds


def run_experiment(exp: Experiment, seed: Seed = 0) -> Report:
    """The function behind ``Experiment.run``."""
    plan = route(exp)
    if plan.reason is not None:
        _LOG.info("falling back to the sequential %r path: %s",
                  plan.path, plan.reason)
    if plan.path == "sweep":
        return _run_sweep_path(exp, seed, plan)
    if plan.path == "grid":
        return _run_grid_path(exp, seed, plan)
    return _run_single_path(exp, seed, plan)


def _run_single_path(exp: Experiment, seed: Seed, plan: RoutePlan) -> Report:
    cfg = as_mocha_config(exp, seed=_scalar_seed(seed))
    res = _run_mocha(exp.problem.train, exp.method.regularizers[0], cfg,
                     omega0=exp.method.omega0,
                     budget_fn=exp.method.budget_fn,
                     engine=exp.exec.resolve_engine(),
                     trace=exp.systems.trace,
                     state0=exp.exec.state0)
    evaluation = None
    if exp.eval.holdout is not None:
        holdout = exp.eval.holdout
        if not isinstance(holdout, FederatedData) or holdout.X.ndim != 3:
            raise ValueError("single-problem holdout must be one (m, n, d) "
                             "FederatedData split")
        evaluation = eval_mod.evaluate_run(
            res.W, holdout, get_loss(exp.method.loss), exp.eval.metrics)
    return Report(result=res, provenance=_provenance(exp, plan),
                  evaluation=evaluation)


def _grid_eval(exp: Experiment, W) -> Any:
    holdout = exp.eval.holdout_stacked()
    if holdout is None:
        return None
    return eval_mod.evaluate_grid(W, holdout, get_loss(exp.method.loss),
                                  exp.eval.metrics)


def _run_sweep_path(exp: Experiment, seed: Seed, plan: RoutePlan) -> Report:
    data = exp.problem.stacked()
    seeds = _shuffle_seeds(seed, data.X.shape[0])
    cfg = as_mocha_config(exp, seed=0)   # the per-shuffle seeds drive it
    res = _run_sweep(data, list(exp.method.regularizers), seeds, cfg)
    return Report(result=res, provenance=_provenance(exp, plan),
                  evaluation=_grid_eval(exp, res.W))


def _run_grid_path(exp: Experiment, seed: Seed, plan: RoutePlan) -> Report:
    """The sequential fallback: every (regularizer, shuffle) cell is one
    core-driver run, on any engine, clock policy or regularizer mix.  Under
    ``semi_sync`` each cell gets a fresh ``SystemsTrace`` from
    ``Systems.config``: the cap matrix the batched sweep pre-samples once."""
    shuffles = exp.problem.shuffle_list()
    regs = exp.method.regularizers
    seeds = _shuffle_seeds(seed, len(shuffles))
    engine = exp.exec.resolve_engine()
    m, d = shuffles[0].m, shuffles[0].d
    for f in shuffles:
        if (f.m, f.d) != (m, d):
            raise ValueError(
                f"cannot grid over federations of shape (m={f.m}, d={f.d}) "
                f"with (m={m}, d={d}); shuffles must share tasks/features")
    R, S = len(regs), len(shuffles)
    W = np.empty((R, S, m, d), np.float32)
    omega = np.empty((R, S, m, m), np.float32)
    dual, primal, gap = (np.empty((R, S)) for _ in range(3))
    for si, data_s in enumerate(shuffles):
        cfg = as_mocha_config(exp, seed=seeds[si],
                              record_every=max(1, exp.method.rounds))
        for ri, reg in enumerate(regs):
            res = _run_mocha(data_s, reg, cfg, omega0=exp.method.omega0,
                             budget_fn=exp.method.budget_fn, engine=engine,
                             state0=exp.exec.state0)
            W[ri, si] = res.W
            omega[ri, si] = res.omega
            dual[ri, si] = res.final("dual")
            primal[ri, si] = res.final("primal")
            gap[ri, si] = res.final("gap")
    result = SweepResult(W=W, omega=omega, dual=dual, primal=primal, gap=gap,
                         regs=tuple(regs), seeds=seeds)
    return Report(result=result, provenance=_provenance(exp, plan),
                  evaluation=_grid_eval(exp, W))
