"""repro_torch.api: the declarative experiment surface of the port.

    from repro_torch.api import Experiment, Problem, Method, Exec

    report = Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=(reg,), rounds=80),
        exec=Exec(engine="kernel"),          # device="cuda" by default
    ).run(seed=0)

The same specs as the JAX package's ``repro.api``, plus ``Exec.device``.
This slice runs the single path; ``report.provenance`` records the engine,
the driver, the resolved gram crossover, the device and the card's name.
"""
from repro_torch.api.execute import run_experiment
from repro_torch.api.report import PROVENANCE_KEYS, Report
from repro_torch.api.router import PATHS, RoutePlan, route
from repro_torch.api.specs import (PROBLEM_KINDS, Eval, Exec, Experiment,
                                   Method, Problem, Systems, as_mocha_config,
                                   config_fingerprint)

__all__ = [
    "Experiment",
    "Problem",
    "Method",
    "Systems",
    "Exec",
    "Eval",
    "Report",
    "RoutePlan",
    "route",
    "run_experiment",
    "as_mocha_config",
    "config_fingerprint",
    "PATHS",
    "PROBLEM_KINDS",
    "PROVENANCE_KEYS",
]
