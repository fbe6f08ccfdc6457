"""Quickstart: federated multi-task learning with MOCHA in ~30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

One declarative surface (repro_torch.api): describe the problem, method,
systems environment, execution substrate, and evaluation -- the capability
router picks the fastest applicable path and the Report carries history,
held-out per-client metrics, and provenance.  The port of the JAX
package's ``examples/quickstart.py``; it runs on the card unless
``--device cpu``.
"""
import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import Eval, Exec, Experiment, Method, Problem, Systems
    from repro_torch.core import BudgetConfig, Probabilistic
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, make_federation

    # 1. a federation: 30 mobile-phone nodes, non-IID unbalanced local data
    train, test = make_federation(HUMAN_ACTIVITY, seed=0, device=args.device)
    print(f"federation: m={train.m} nodes, d={train.d} features, "
          f"n_t in [{int(train.n_t.min())}, {int(train.n_t.max())}]")

    # 2. MOCHA: per-node SVMs + learned task relationships,
    # straggler-tolerant
    experiment = Experiment(
        problem=Problem(train=train),
        method=Method(
            loss="hinge", regularizers=Probabilistic(lam=1e-2, sigma2=10.0),
            rounds=80, omega_update_every=20,
            budget=BudgetConfig(passes=1.0, systems_lo=0.5, drop_prob=0.1)),
        systems=Systems(network="lte"),
        exec=Exec(device=args.device),
        eval=Eval(record_every=10, holdout=test),
    )
    report = experiment.run(seed=0)

    # 3. inspect: history, per-client held-out eval, and provenance ride
    # along
    result = report.result
    print(f"final duality gap: {report.final('gap'):.4f}")
    print(f"simulated federated wall-clock: {report.final('time'):.1f}s (LTE)")
    print(f"avg test error across tasks: "
          f"{report.evaluation.summary['mean_error']:.4f}")
    print(f"worst client held-out error: "
          f"{report.evaluation.per_client['error'].max():.4f}")
    print(f"learned Omega diag (task self-affinity): "
          f"{np.round(np.diagonal(np.asarray(result.omega))[:6], 3)}")
    print(f"executed as: {report.provenance['path']}/"
          f"{report.provenance['driver']} on {report.provenance['engine']} "
          f"({report.provenance['device_name']}, config "
          f"{report.provenance['config_hash']})")
    return report


if __name__ == "__main__":
    main()
