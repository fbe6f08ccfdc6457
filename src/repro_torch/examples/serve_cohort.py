"""Online serving: per-client predictions while training streams behind.

    PYTHONPATH=src python -m repro_torch.examples.serve_cohort \
        [--clients 2000] [--device cpu]

MOCHA's output is a model PER CLIENT -- what a federated system serves.
``Experiment.serve()`` attaches an online prediction tier
(``repro_torch.serve``) to a cross-device cohort run: training blocks
stream on a background thread, an immutable versioned snapshot of the
served state (cluster centroids, assignments and cached personal deltas)
is published every ``publish_every`` folds, and ``predict(ids, X)``
answers from the newest snapshot at any moment -- also before the first
block lands (cold clients resolve to their cluster centroid) and for
clients the run never sampled.  Serving never perturbs training: the run
below gives the bits of the same experiment with serving off.
"""
import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import Eval, Exec, Experiment, Method, Problem, Serve
    from repro_torch.cohort import Population, PopulationSpec
    from repro_torch.core import BudgetConfig, Probabilistic

    # 1. a device population: clients stream in, nobody holds all the data
    spec = PopulationSpec("serve_demo", m=args.clients, d=12, n_min=12,
                          n_max=32, clusters=3)
    pop = Population(spec, seed=0)
    print(f"population: m={pop.m} clients, d={spec.d} features, "
          f"{spec.clusters} latent clusters")

    # 2. the experiment, served online: snapshots publish every 2 folds
    experiment = Experiment(
        problem=Problem(population=pop),
        method=Method(loss="hinge",
                      regularizers=(Probabilistic(lam=1e-2, sigma2=10.0),),
                      rounds=args.rounds, budget=BudgetConfig(passes=1.0)),
        exec=Exec(cohort=32, clusters=spec.clusters, device=args.device),
        eval=Eval(record_every=1, holdout_clients=20))
    session = experiment.serve(seed=0, serve=Serve(publish_every=2))

    # 3. predictions are live from t=0: cold clients get their centroid
    ids = np.arange(8)
    X = np.stack([pop.client_block(int(t)).X[0] for t in ids])
    print(f"v{session.snapshot_version} (cold) margins: "
          f"{np.round(session.predict(ids, X), 3)}")

    # 4. train in the background; keep serving while snapshots swap in
    session.start()
    versions = set()
    while session.training:
        versions.add(int(session.snapshot_version))
        session.predict(ids, X)
    session.join()
    print(f"served across versions {sorted(versions)} while "
          f"{args.rounds} cohort blocks streamed (max version lag "
          f"{session.predictor.max_version_lag})")

    # 5. the final snapshot serves the trained per-client models
    z = session.predict(ids, X)
    print(f"v{session.snapshot_version} (trained) margins: {np.round(z, 3)}")
    report = session.report()
    print(f"held-out cold-client error: "
          f"{report.evaluation.summary['mean_error']:.4f} over "
          f"{int(report.evaluation.summary['holdout_clients'])} clients")
    print(f"executed as: {report.provenance['path']}/"
          f"{report.provenance['driver']} on {report.provenance['engine']} "
          f"({report.provenance['device_name']}, config "
          f"{report.provenance['config_hash']})")


if __name__ == "__main__":
    main()
