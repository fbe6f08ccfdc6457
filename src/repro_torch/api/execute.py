"""Experiment execution: route, run, evaluate, stamp provenance.

``run_experiment`` is the one function behind ``Experiment.run`` and
``serve_experiment`` the one behind ``Experiment.serve``.  The
single path is the core driver (``repro_torch.core.mocha``), the batched
grid is the sweep (``repro_torch.core.sweep``), the grid fallback runs the
core driver cell by cell, and the cross-device path is the cohort block
loop (``repro_torch.cohort.driver``).  What lives here is the glue: seeds,
held-out evaluation, telemetry and the provenance block.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.report import Report
from repro_torch.api.router import RoutePlan, route
from repro_torch.api.specs import (Experiment, Serve, as_cohort_config,
                                   as_mocha_config, config_fingerprint)
from repro_torch.cohort.driver import _run_cohort
from repro_torch.core import evaluate as eval_mod
from repro_torch.core.dual import FederatedData
from repro_torch.core.losses import get_loss
from repro_torch.core.mocha import _run_mocha
from repro_torch.core.subproblem import active_gram_max_d
from repro_torch.core.sweep import SweepResult, _run_sweep
from repro_torch.utils.device import resolve_device
from repro_torch.utils.dist import writes_files

_LOG = logging.getLogger("repro_torch.api")

Seed = Union[int, Sequence[int]]


def _device_fields(device) -> Dict[str, Any]:
    dev = resolve_device(device)
    return {"backend": dev.type, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


def base_provenance(device=None) -> Dict[str, Any]:
    """The provenance block of work run outside the router (micro-
    benchmarks, raw solver calls): the resolved crossover and the device
    (the card unless ``device`` says otherwise), the router's fields
    empty."""
    return {"path": None, "driver": None, "engine": None,
            "fallback_reason": None, "gram_max_d": int(active_gram_max_d()),
            "gram_mode": None, "config_hash": None,
            **_device_fields(device),
            "retries": None, "degraded_blocks": None,
            "telemetry": None, "trace_path": None}


def _provenance(exp: Experiment, plan: RoutePlan) -> Dict[str, Any]:
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
        **_device_fields(exp.exec.device),
        # fault accounting: only the cohort path retries and degrades
        "retries": None,
        "degraded_blocks": None,
        # the flat metrics summary and trace path, when telemetry is on
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


def _seed_tag(seed: Seed) -> str:
    if isinstance(seed, (int, np.integer)):
        return str(int(seed))
    return "-".join(str(int(s)) for s in seed)


def _finalize_telemetry(exp: Experiment, tel: obs.Telemetry, seed: Seed,
                        report: Report) -> None:
    """Merge the flat metrics summary (and the trace's path) into the
    provenance block.  The trace's file name is a pure function of (config
    hash, seed), so a rerun overwrites it; under a process group rank 0
    alone writes it."""
    if not tel.enabled:
        return
    prov = report.provenance
    prov["telemetry"] = obs.metrics_summary(tel)
    if exp.exec.trace_dir is not None:
        stem = (f"trace_{prov.get('config_hash') or 'run'}"
                f"_s{_seed_tag(seed)}.json")
        path = os.path.join(exp.exec.trace_dir, stem)
        prov["trace_path"] = (obs.write_trace(path, tel) if writes_files()
                              else path)


def run_experiment(exp: Experiment, seed: Seed = 0) -> Report:
    """The function behind ``Experiment.run``."""
    tel = obs.telemetry(exp.exec.telemetry or exp.exec.trace_dir is not None)
    plan = route(exp)
    # the router's decision, as a trace event
    tel.event("route", path=plan.path, driver=plan.driver,
              engine=plan.engine, fallback_reason=plan.reason)
    if plan.reason is not None:
        _LOG.info("falling back to the sequential %r path: %s",
                  plan.path, plan.reason)
    with tel.span("experiment", path=plan.path):
        if plan.path == "cohort":
            report = _run_cohort_path(exp, seed, plan, tel)
        elif plan.path == "sweep":
            report = _run_sweep_path(exp, seed, plan)
        elif plan.path == "grid":
            report = _run_grid_path(exp, seed, plan, tel)
        else:
            report = _run_single_path(exp, seed, plan, tel)
    _finalize_telemetry(exp, tel, seed, report)
    return report


def _run_single_path(exp: Experiment, seed: Seed, plan: RoutePlan,
                     tel: obs.Telemetry = obs.NULL_TELEMETRY) -> Report:
    cfg = as_mocha_config(exp, seed=_scalar_seed(seed))
    res = _run_mocha(exp.problem.train, exp.method.regularizers[0], cfg,
                     omega0=exp.method.omega0,
                     budget_fn=exp.method.budget_fn,
                     engine=exp.exec.resolve_engine(),
                     trace=exp.systems.trace,
                     state0=exp.exec.state0,
                     telemetry=tel)
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


def _run_grid_path(exp: Experiment, seed: Seed, plan: RoutePlan,
                   tel: obs.Telemetry = obs.NULL_TELEMETRY) -> Report:
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
            with tel.span("grid.cell", shuffle=si, reg=ri):
                res = _run_mocha(data_s, reg, cfg, omega0=exp.method.omega0,
                                 budget_fn=exp.method.budget_fn,
                                 engine=engine, state0=exp.exec.state0,
                                 telemetry=tel)
            W[ri, si] = res.W
            omega[ri, si] = res.omega
            dual[ri, si] = res.final("dual")
            primal[ri, si] = res.final("primal")
            gap[ri, si] = res.final("gap")
    result = SweepResult(W=W, omega=omega, dual=dual, primal=primal, gap=gap,
                         regs=tuple(regs), seeds=seeds)
    return Report(result=result, provenance=_provenance(exp, plan),
                  evaluation=_grid_eval(exp, W))


def _cohort_report(exp: Experiment, plan: RoutePlan, s: int, res) -> Report:
    """Report of a finished cohort run: held-out clients (when
    ``Eval.holdout_clients`` is set) and the provenance with the run's
    fault accounting.  Shared by the batch path (``_run_cohort_path``) and
    the serving path (``serve_experiment``), so the two report alike."""
    evaluation = None
    if exp.eval.holdout_clients > 0:
        evaluation = eval_mod.evaluate_cohort(
            exp.problem.population, res.relationship,
            get_loss(exp.method.loss), exp.eval.holdout_clients, seed=s,
            participation=res.participation, metrics=exp.eval.metrics)
    prov = _provenance(exp, plan)
    if res.fault_stats is not None:
        prov["retries"] = int(res.fault_stats.retries)
        prov["degraded_blocks"] = int(res.fault_stats.degraded_blocks)
    return Report(result=res, provenance=prov, evaluation=evaluation)


def _run_cohort_path(exp: Experiment, seed: Seed, plan: RoutePlan,
                     tel: obs.Telemetry = obs.NULL_TELEMETRY) -> Report:
    s = _scalar_seed(seed)
    cfg = as_cohort_config(exp, seed=s)
    res = _run_cohort(exp.problem.population, exp.method.regularizers[0], cfg,
                      telemetry=tel)
    return _cohort_report(exp, plan, s, res)


def serve_experiment(exp: Experiment, seed: Seed = 0,
                     serve: Optional[Serve] = None):
    """The function behind ``Experiment.serve()``: an online
    ``repro_torch.serve.ServeSession`` over the experiment's cohort run, on
    the run's device.  Raises for experiments the router would not send
    down the cohort path -- serving is a population-scale feature.  The
    session's ``report()`` gives the evaluation and provenance (telemetry
    included) that ``Experiment.run`` gives on the finished result.
    """
    from repro_torch.serve.refresh import ServeSession
    spec = serve if serve is not None else Serve()
    plan = route(exp)
    if plan.path != "cohort":
        raise ValueError(
            "Experiment.serve() needs a population-scale problem (cohort "
            f"path); the router picked {plan.path!r}"
            + (f" because {plan.reason}" if plan.reason else ""))
    tel = obs.telemetry(exp.exec.telemetry or exp.exec.trace_dir is not None)
    s = _scalar_seed(seed)
    cfg = as_cohort_config(exp, seed=s)

    def build_report(res) -> Report:
        report = _cohort_report(exp, plan, s, res)
        _finalize_telemetry(exp, tel, s, report)
        return report

    return ServeSession(exp.problem.population, exp.method.regularizers[0],
                        cfg, publish_every=spec.publish_every,
                        prewarm=spec.prewarm, telemetry=tel,
                        report_builder=build_report)
