"""The port's (shuffle x regularizer) grids: the batched sweep, the grid
fallback, and the router that picks between them.

Each sweep cell is held against the JAX package's single run of the same
cell (``engine="local"``), not against JAX's batched sweep, whose bitwise
contracts break under JAX 0.9: final objectives within rtol 1e-5 / atol
1e-4, W and Omega within atol 1e-5.  The grid path on the kernel engine (its
plain version on the CPU) is held against the sweep at the same tolerance.
"""
import numpy as np
import pytest

import repro.api as ja
import repro.core as jc
from repro.cohort import Population, PopulationSpec
from repro.core.sweep import grid_batch_reason as jax_grid_batch_reason
from repro.core.sweep import stack_federations as jax_stack
from repro.data.synthetic import FederationSpec as JSpec
from repro.data.synthetic import make_federation as jax_federation
import repro_torch.api as ta
import repro_torch.core as tc
from repro_torch.convert import federation_from_numpy
from repro_torch.core.sweep import _run_sweep
from repro_torch.data.synthetic import FederationSpec as TSpec
from repro_torch.data.synthetic import make_federation

#: shuffles of unequal size, so stacking pads all but the largest
SPEC = dict(name="sweep", m=3, d=5, n_min=14, n_max=30, clusters=2,
            label_noise=0.0)
SEMI = dict(network="3g", policy="semi_sync", clock_cycle_s=1e-5,
            rate_lo=0.5, rate_hi=1.5, straggler_prob=0.2, seed=3)
LAMBDAS = (0.01, 0.1, 1.0)
SEEDS = (0, 1)


def _shuffles():
    jax_splits = [jax_federation(JSpec(**SPEC), seed=s) for s in SEEDS]
    port_splits = [make_federation(TSpec(**SPEC), seed=s, device="cpu")
                   for s in SEEDS]
    return jax_splits, port_splits


def _regs(pkg, name):
    kw = {"clustered": dict(eta=0.5, k=2), "probabilistic": dict(sigma2=10.0)}
    return tuple(pkg.REGULARIZERS[name](lam=lam, **kw[name])
                 for lam in LAMBDAS)


def test_stack_federations_pads_like_jax():
    jax_splits, port_splits = _shuffles()
    j = jax_stack([tr for tr, _ in jax_splits])
    t = tc.stack_federations([tr for tr, _ in port_splits])
    assert len({tr.n_max for tr, _ in port_splits}) == 2   # padding bites
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="cannot stack"):
        tc.stack_federations([port_splits[0][0], make_federation(
            TSpec(**dict(SPEC, d=4)), device="cpu")[0]])
    # the stack carried across from numpy is the same stack
    carried = federation_from_numpy(*(np.asarray(a) for a in j[:3]),
                                    device="cpu")
    for a, b in zip(carried[:3], t[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("reg", ["probabilistic", "clustered"])
@pytest.mark.parametrize("systems", [None, SEMI], ids=["sync", "semi_sync"])
def test_sweep_cells_match_jax_single_runs(reg, systems):
    jax_splits, port_splits = _shuffles()
    method = dict(rounds=6, omega_update_every=3,
                  budget=dict(systems_lo=0.3) if systems else {})
    rep = ta.Experiment(
        problem=ta.Problem(train=[tr for tr, _ in port_splits]),
        method=ta.Method(regularizers=_regs(tc, reg), rounds=6,
                         omega_update_every=3,
                         budget=tc.BudgetConfig(**method["budget"])),
        systems=ta.Systems(config=None if systems is None
                           else tc.SystemsConfig(**systems)),
        exec=ta.Exec(device="cpu"),
        eval=ta.Eval(holdout=[te for _, te in port_splits])).run(SEEDS)
    assert (rep.provenance["path"], rep.provenance["driver"],
            rep.provenance["fallback_reason"]) == ("sweep", "vmap", None)
    res = rep.result
    assert res.W.shape == (3, 2, 3, 5) and res.seeds == SEEDS
    for r, jreg in enumerate(_regs(jc, reg)):
        for s, (jtrain, _) in enumerate(jax_splits):
            jrep = ja.Experiment(
                problem=ja.Problem(train=jtrain),
                method=ja.Method(regularizers=(jreg,), rounds=6,
                                 omega_update_every=3,
                                 budget=jc.BudgetConfig(**method["budget"])),
                systems=ja.Systems(config=None if systems is None
                                   else jc.SystemsConfig(**systems)),
            ).run(SEEDS[s])
            for k in ("dual", "primal", "gap"):
                np.testing.assert_allclose(
                    getattr(res, k)[r, s], jrep.final(k), rtol=1e-5,
                    atol=1e-4, err_msg=f"{k} cell ({r}, {s})")
            np.testing.assert_allclose(res.W[r, s], np.asarray(jrep.result.W),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(res.omega[r, s],
                                       np.asarray(jrep.result.omega),
                                       atol=1e-5, rtol=0)
    # held-out errors of the port's W: the report's grid and sweep_errors
    # against the JAX package's sweep_errors on the same W and test split
    # (a mean over tasks, summed in another order: rtol 1e-6)
    grid = rep.evaluation.grid
    assert grid.shape == (3, 2)
    want = jc.sweep_errors(res.W, jax_stack([te for _, te in jax_splits]))
    np.testing.assert_allclose(grid, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tc.sweep_errors(res, ta.Eval(
        holdout=[te for _, te in port_splits]).holdout_stacked()), grid)


def test_grid_path_on_the_kernel_engine_matches_the_sweep():
    _, port_splits = _shuffles()
    regs = _regs(tc, "probabilistic")

    def run(engine):
        return ta.Experiment(
            problem=ta.Problem(train=[tr for tr, _ in port_splits]),
            method=ta.Method(regularizers=regs, rounds=6,
                             omega_update_every=3),
            exec=ta.Exec(engine=engine, device="cpu"),
            eval=ta.Eval(holdout=[te for _, te in port_splits])).run(SEEDS)

    sweep, grid = run("local"), run("kernel")
    assert grid.provenance["path"] == "grid"
    assert grid.provenance["driver"] == "loop"
    assert "engine 'kernel' has no vmapped" in grid.provenance[
        "fallback_reason"]
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(getattr(grid.result, k),
                                   getattr(sweep.result, k), rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_allclose(grid.result.W, sweep.result.W, atol=1e-5,
                               rtol=0)
    assert grid.evaluation.grid.shape == sweep.evaluation.grid.shape


def test_sweep_checks_its_inputs():
    _, port_splits = _shuffles()
    data = [tr for tr, _ in port_splits]
    cfg = tc.MochaConfig(rounds=2, device="cpu")
    regs = _regs(tc, "probabilistic")
    with pytest.raises(ValueError, match="seeds for 2 shuffles"):
        _run_sweep(data, regs, (0, 1, 2), cfg)
    with pytest.raises(ValueError, match="local engine only"):
        _run_sweep(data, regs, 0, tc.MochaConfig(engine="kernel",
                                                 device="cpu"))
    with pytest.raises(ValueError, match=r"stacked \(S, m, n, d\)"):
        _run_sweep(data[0], regs, 0, cfg)
    with pytest.raises(TypeError, match="mixed regularizer types"):
        _run_sweep(data, (tc.MeanRegularized(), tc.Probabilistic()), 0, cfg)


@pytest.mark.parametrize("case", ["batchable", "mixed", "non_numeric",
                                  "int_field", "degenerate"])
def test_grid_batch_reason_strings_equal_jax(case):
    def grid(pkg):
        return {
            "batchable": (pkg.Probabilistic(lam=0.1),
                          pkg.Probabilistic(lam=1.0)),
            "mixed": (pkg.MeanRegularized(), pkg.Probabilistic()),
            "non_numeric": (pkg.MeanRegularized(name="a"),
                            pkg.MeanRegularized(name="b")),
            "int_field": (pkg.Clustered(k=2), pkg.Clustered(k=3)),
            "degenerate": (pkg.Clustered(), pkg.Clustered()),
        }[case]
    assert (tc.grid_batch_reason(grid(tc))
            == jax_grid_batch_reason(grid(jc)))


# -- the router: the JAX package's golden table, mirrored --------------------

_REG = dict(lambda1=0.5, lambda2=0.5)
_SEMI = dict(network="3g", policy="semi_sync", clock_cycle_s=1e-5,
             rate_lo=0.5, rate_hi=1.5)

#: (problem kind, engine, semi_sync?) -> (path, inner driver, fallback?);
#: the JAX table of tests/test_api.py with ``pallas`` -> ``kernel``
GOLDEN_ROUTES = [
    ("silo", "local", False, "single", "scan", False),
    ("silo", "local", True, "single", "scan", False),
    ("silo", "kernel", False, "single", "loop", False),
    ("silo", "sharded", True, "single", "loop", False),
    ("shuffles", "local", False, "sweep", "vmap", False),
    ("shuffles", "local", True, "sweep", "vmap", False),
    ("shuffles", "kernel", False, "grid", "loop", True),
    ("shuffles", "kernel", True, "grid", "loop", True),
    ("shuffles", "sharded", False, "grid", "loop", True),
    ("shuffles", "sharded", True, "grid", "loop", True),
    ("population", "sharded", False, "cohort", "loop", False),
]

#: a small population for the router's table
POP = dict(name="pop", m=300, d=12, n_min=12, n_max=32)


def _problem(pkg, kind):
    if kind == "population":
        if pkg is ja:
            return ja.Problem(population=Population(PopulationSpec(**POP),
                                                    seed=0))
        from repro_torch.cohort import Population as TPopulation
        from repro_torch.cohort import PopulationSpec as TPopulationSpec
        return ta.Problem(population=TPopulation(TPopulationSpec(**POP),
                                                 seed=0))
    train = (jax_federation(JSpec(**SPEC))[0] if pkg is ja
             else make_federation(TSpec(**SPEC), device="cpu")[0])
    if kind == "shuffles":
        return pkg.Problem(train=[train, train])
    return pkg.Problem(train=train)


@pytest.mark.parametrize("kind,engine,semi,path,driver,falls_back",
                         GOLDEN_ROUTES)
def test_router_golden_table(kind, engine, semi, path, driver, falls_back):
    plans = []
    for pkg, core, eng in ((ja, jc, "pallas" if engine == "kernel"
                            else engine), (ta, tc, engine)):
        systems = pkg.Systems(config=core.SystemsConfig(**_SEMI)
                              if semi else None)
        plans.append(pkg.route(pkg.Experiment(
            problem=_problem(pkg, kind),
            method=pkg.Method(regularizers=(core.MeanRegularized(**_REG),)),
            systems=systems, exec=pkg.Exec(engine=eng))))
    jplan, tplan = plans
    assert tplan.path in ta.PATHS and tplan.driver in ta.INNER_DRIVERS
    assert (tplan.path, tplan.driver) == (path, driver)
    assert (jplan.path, jplan.driver) == (path, driver)
    assert tplan.engine == engine
    assert (tplan.reason is not None) == falls_back
    if falls_back:   # the same wall, with the engine's own name
        assert tplan.reason == jplan.reason.replace("pallas", "kernel")


@pytest.mark.parametrize("kind", ["silo", "shuffles"])
def test_router_sharded_and_population_name_their_items(kind):
    """The sharded engine (item 13) routes as in the JAX package and its
    experiment runs; a population routes to the cohort path, as in the
    JAX package, on either engine."""
    jplan = ja.route(ja.Experiment(problem=_problem(ja, kind),
                                   exec=ja.Exec(engine="sharded")))
    exp = ta.Experiment(
        problem=_problem(ta, kind),
        method=ta.Method(regularizers=(tc.MeanRegularized(**_REG),),
                         rounds=2),
        exec=ta.Exec(engine="sharded", device="cpu"))
    tplan = ta.route(exp)
    assert (tplan.path, tplan.driver, tplan.reason) == (
        jplan.path, jplan.driver, jplan.reason)
    rep = exp.run(0)
    assert (rep.provenance["path"], rep.provenance["engine"]) == (
        tplan.path, "sharded")
    assert np.isfinite(rep.result.W).all()
    engine = "local" if kind == "silo" else "kernel"
    jplan = ja.route(ja.Experiment(
        problem=_problem(ja, "population"),
        exec=ja.Exec(engine="pallas" if engine == "kernel" else engine)))
    tplan = ta.route(ta.Experiment(problem=_problem(ta, "population"),
                                   exec=ta.Exec(engine=engine)))
    assert (tplan.path, tplan.driver, tplan.reason) == (
        jplan.path, jplan.driver, jplan.reason)
    assert tplan.path == "cohort" and tplan.engine == engine


def test_router_single_reg_grid_is_sweep_and_walls_match_jax():
    port = make_federation(TSpec(**SPEC), device="cpu")[0]
    grid = tuple(tc.MeanRegularized(lambda1=0.0, lambda2=lam)
                 for lam in LAMBDAS)
    plan = ta.route(ta.Experiment(problem=ta.Problem(train=port),
                                  method=ta.Method(regularizers=grid)))
    assert (plan.path, plan.driver) == ("sweep", "vmap")
    walls = [
        (dict(method=ta.Method(regularizers=grid, budget_fn=lambda k, n, h:
                               n)), "budget_fn"),
        (dict(method=ta.Method(regularizers=grid),
              exec=ta.Exec(driver="loop")), "driver='loop'"),
        (dict(method=ta.Method(regularizers=(tc.MeanRegularized(),
                                             tc.Probabilistic()))),
         "mixed regularizer types"),
    ]
    for kw, words in walls:
        plan = ta.route(ta.Experiment(problem=ta.Problem(train=port), **kw))
        assert plan.path == "grid" and words in plan.reason
    with pytest.raises(ValueError, match="SystemsTrace"):
        ta.route(ta.Experiment(problem=ta.Problem(train=port),
                               method=ta.Method(regularizers=grid),
                               systems=ta.Systems(trace=tc.SystemsTrace(3,
                                                                        5))))
    with pytest.raises(ValueError, match="scanned driver"):
        ta.route(ta.Experiment(problem=ta.Problem(train=port),
                               exec=ta.Exec(engine="kernel", driver="scan")))


def test_problem_and_eval_views():
    _, port_splits = _shuffles()
    trains = [tr for tr, _ in port_splits]
    prob = ta.Problem(train=trains)
    stacked = prob.stacked()
    assert stacked.X.shape[0] == 2 and prob.kind == "shuffles"
    assert ta.Problem(train=stacked).kind == "shuffles"
    sliced = ta.Problem(train=stacked).shuffle_list()
    assert len(sliced) == 2 and sliced[0].X.shape == stacked.X.shape[1:]
    assert prob.shuffle_list() == tuple(trains)
    assert ta.Problem(train=trains[0]).stacked().X.shape[0] == 1
    assert ta.Eval().holdout_stacked() is None
    assert ta.Eval(holdout=trains[0]).holdout_stacked().X.dim() == 4
