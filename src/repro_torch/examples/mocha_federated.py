"""End-to-end MOCHA study on one federation: MTL-vs-baselines, straggler
robustness, fault tolerance, and the three round engines (local / the
Hopper SDCA kernel / sharded over a process group) driving the SAME
experiment spec through the capability router.

    PYTHONPATH=src python -m repro_torch.examples.mocha_federated \
        [--device cpu]

The port of the JAX package's ``examples/mocha_federated.py``: its four
sections at its sizes, each a function whose round counts default to the
JAX script's.  The engines are held to the port's contract, not to bit
identity: one-rank ``sharded`` gives the local engine's bits, and
``kernel`` is within ``KERNEL_RTOL`` x |primal| of the local engine at
every recorded round.  The script exits 1 when an engine misses its limit.
Runs on the card unless ``--device cpu``.
"""
import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.utils.timing import tick

#: the kernel engine's primal against the local engine's, relative, at
#: every recorded round (the kernel folds floats in another order)
KERNEL_RTOL = 1e-4
#: each engine's limit on max |primal - primal_local| / |primal_local|;
#: 0.0 means bit for bit, W included
ENGINE_LIMITS = {"local": 0.0, "kernel": KERNEL_RTOL, "sharded": 0.0}
#: the engines section's rounds, as the JAX script runs it
ENGINE_ROUNDS = 40


def federation(device):
    """(train, test, reg): Vehicle Sensor (seed 0) and the study's
    mean-regularized coupling."""
    from repro_torch.core import MeanRegularized
    from repro_torch.data.synthetic import VEHICLE_SENSOR, make_federation
    train, test = make_federation(VEHICLE_SENSOR, seed=0, device=device)
    return train, test, MeanRegularized(lambda1=0.1, lambda2=0.1)


def _base(train, test, reg, device, rounds):
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem, Systems
    from repro_torch.core import BudgetConfig
    return Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=reg, rounds=rounds,
                      budget=BudgetConfig(passes=0.5)),
        systems=Systems(network="lte"),
        exec=Exec(device=device),
        eval=Eval(record_every=rounds - 1, holdout=test),
    )


def methods(train, test, reg, device, rounds=60):
    """MOCHA against CoCoA, Mb-SGD and Mb-SDCA on simulated LTE."""
    from repro_torch.core import (BudgetConfig, MiniBatchConfig, MochaConfig,
                                  run_cocoa, run_mb_sdca, run_mb_sgd)
    print(f"== methods, {rounds} rounds on simulated LTE ==")
    mocha = _base(train, test, reg, device, rounds).run(seed=0)
    cocoa = run_cocoa(train, reg, MochaConfig(
        loss="hinge", rounds=rounds, budget=BudgetConfig(passes=1.0),
        per_task_sigma=False, network="lte", record_every=rounds - 1,
        device=device))
    mb = MiniBatchConfig(loss="hinge", rounds=rounds, batch=16, lr=0.05,
                         network="lte", record_every=rounds - 1)
    sgd, sdca = run_mb_sgd(train, reg, mb), run_mb_sdca(train, reg, mb)
    out = {"MOCHA": mocha, "CoCoA": cocoa, "Mb-SGD": sgd, "Mb-SDCA": sdca}
    for name, res in out.items():
        print(f"  {name:8s} primal={res.final('primal'):10.2f}  "
              f"sim_time={res.final('time'):8.2f}s")
    print(f"  MOCHA held-out mean error: "
          f"{mocha.evaluation.summary['mean_error']:.4f}")
    return out


def robustness(train, test, reg, device, rounds=120):
    """MOCHA clean, under high-variance systems and under 25% drops."""
    from repro_torch.api import Eval, Method
    from repro_torch.core import BudgetConfig
    print("== straggler + drop robustness (MOCHA) ==")
    base = _base(train, test, reg, device, rounds)
    out = {}
    for label, budget in [
            ("clean", BudgetConfig(passes=1.0)),
            ("high-variance systems", BudgetConfig(passes=1.0,
                                                   systems_lo=0.1)),
            ("25% drops", BudgetConfig(passes=1.0, drop_prob=0.25))]:
        rep = dataclasses.replace(
            base,
            method=Method(loss="hinge", regularizers=reg, rounds=rounds,
                          budget=budget),
            eval=Eval(record_every=rounds - 1)).run(seed=0)
        print(f"  {label:24s} gap={rep.final('gap'):9.4f}")
        out[label] = rep
    return out


def engines(train, test, reg, device, rounds=ENGINE_ROUNDS):
    """One spec on the three engines, each held to its limit against the
    local engine.  Returns ``(runs, ok)``."""
    from repro_torch.api import Eval, Exec, Method
    from repro_torch.core import BudgetConfig
    print("== one spec, three engines (each within its limit of local) ==")
    eng_exp = dataclasses.replace(
        _base(train, test, reg, device, rounds),
        method=Method(loss="hinge", regularizers=reg, rounds=rounds,
                      budget=BudgetConfig(passes=1.0)),
        eval=Eval(record_every=rounds - 1))
    runs = {e: dataclasses.replace(
                eng_exp, exec=Exec(engine=e, device=device)).run(seed=0)
            for e in ENGINE_LIMITS}
    ref = runs["local"]
    p_ref = np.asarray(ref.history["primal"], np.float64)
    ok = True
    for name, rep in runs.items():
        dW = float(np.max(np.abs(np.asarray(rep.result.W, np.float64)
                                 - np.asarray(ref.result.W, np.float64))))
        p = np.asarray(rep.history["primal"], np.float64)
        rel = float(np.max(np.abs(p - p_ref) / np.abs(p_ref)))
        limit = ENGINE_LIMITS[name]
        held = (dW == 0.0 and rel == 0.0) if limit == 0.0 else rel <= limit
        ok &= held
        rule = ("bit for bit" if limit == 0.0
                else f"primal within {limit:g} x |primal|")
        print(f"  {name:8s} primal={rep.final('primal'):10.2f} "
              f"gap={rep.final('gap'):.4f}  max|W - W_local|={dW:.3e}  "
              f"max|dprimal|/|primal|={rel:.3e}  limit: {rule}  "
              f"{'ok' if held else 'MISSED'}  "
              f"(driver: {rep.provenance['driver']})")
    return runs, ok


def semi_sync(train, test, reg, device, rounds=60):
    """MOCHA under the semi-synchronous clock cycle: the trace caps each
    node's budget instead of waiting for the straggler."""
    from repro_torch.api import Eval, Method, Systems
    from repro_torch.core import BudgetConfig, SystemsConfig, systems_model
    print("== semi_sync clock cycle: the trace caps budgets, not the "
          "straggler ==")
    cycle = 0.5 * float(np.mean(train.n_t.cpu().numpy())) \
        * systems_model.SDCA_STEP_FLOPS(train.d) / systems_model.CLOCK_FLOPS
    semi = dataclasses.replace(
        _base(train, test, reg, device, rounds),
        method=Method(loss="hinge", regularizers=reg, rounds=rounds,
                      budget=BudgetConfig(passes=1.0)),
        systems=Systems(config=SystemsConfig(
            policy="semi_sync", clock_cycle_s=cycle, rate_lo=0.25,
            rate_hi=1.0, straggler_prob=0.1)),
        eval=Eval(record_every=rounds - 1)).run(seed=0)
    print(f"  semi_sync primal={semi.final('primal'):.2f} "
          f"sim_time={semi.final('time'):.2f}s  {semi.trace.summary()}")
    return semi


def main(argv=None) -> int:
    """Runs the four sections, printing each one's wall; 0 when every
    engine met its limit, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train, test, reg = federation(args.device)
    ok = True
    for section in (methods, robustness, engines, semi_sync):
        t0 = tick()
        out = section(train, test, reg, args.device)
        print(f"  [{section.__name__}: {tick() - t0:.2f} s wall]")
        if section is engines:
            ok = out[1]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
