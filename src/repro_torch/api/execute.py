"""Experiment execution: route, run, stamp provenance."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.api.report import Report
from repro_torch.api.router import RoutePlan, route
from repro_torch.api.specs import (Experiment, as_mocha_config,
                                   config_fingerprint)
from repro_torch.core.mocha import _run_mocha
from repro_torch.core.subproblem import active_gram_max_d
from repro_torch.utils.device import resolve_device


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


def _scalar_seed(seed) -> int:
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    raise ValueError(
        "this experiment runs a single problem; pass one integer seed "
        f"(got {seed!r})")


def run_experiment(exp: Experiment, seed: int = 0) -> Report:
    """The function behind ``Experiment.run``: the single path."""
    plan = route(exp)
    cfg = as_mocha_config(exp, seed=_scalar_seed(seed))
    res = _run_mocha(exp.problem.train, exp.method.regularizers[0], cfg,
                     omega0=exp.method.omega0,
                     budget_fn=exp.method.budget_fn,
                     engine=exp.exec.resolve_engine(),
                     trace=exp.systems.trace,
                     state0=exp.exec.state0)
    return Report(result=res, provenance=_provenance(exp, plan))
