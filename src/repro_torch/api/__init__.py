"""repro_torch.api: the declarative experiment surface of the port.

    from repro_torch.api import Experiment, Problem, Method, Exec

    report = Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=(reg,), rounds=80),
        exec=Exec(engine="kernel"),          # device="cuda" by default
    ).run(seed=0)

The same specs as the JAX package's ``repro.api``, plus ``Exec.device``.
The port runs the single path, the (shuffle x regularizer) grids, batched
(``sweep``) or cell by cell (``grid``), with held-out evaluation
(``Eval(holdout=...)``), and the cross-device cohort path over a
population (``Problem(population=...)``, with ``Eval(holdout_clients=...)``);
``Exec(telemetry=True)`` or ``Exec(trace_dir=...)`` records spans and
metrics on any path.  ``report.provenance`` records the path, the inner
driver, the fallback reason, the engine, the resolved gram crossover, the
device and the card's name.  ``Experiment.serve(seed, Serve(...))``
(``serve_experiment``) serves a population's per-client models from
atomically swapped snapshots while its cohort run trains.
"""
from repro_torch.api.execute import (base_provenance, run_experiment,
                                     serve_experiment)
from repro_torch.api.report import PROVENANCE_KEYS, Report
from repro_torch.api.router import (INNER_DRIVERS, PATHS, RoutePlan,
                                    batch_incompatibility, route)
from repro_torch.api.specs import (PROBLEM_KINDS, Eval, Exec, Experiment,
                                   Method, Problem, Serve, Systems,
                                   as_cohort_config, as_mocha_config,
                                   config_fingerprint)
from repro_torch.core.evaluate import METRICS, EvalReport

__all__ = [
    "Experiment",
    "Problem",
    "Method",
    "Systems",
    "Exec",
    "Eval",
    "Serve",
    "Report",
    "EvalReport",
    "RoutePlan",
    "route",
    "batch_incompatibility",
    "run_experiment",
    "serve_experiment",
    "as_mocha_config",
    "as_cohort_config",
    "config_fingerprint",
    "base_provenance",
    "PATHS",
    "INNER_DRIVERS",
    "PROBLEM_KINDS",
    "PROVENANCE_KEYS",
    "METRICS",
]
