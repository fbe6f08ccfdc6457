"""Whole MOCHA runs of the port against the JAX package's ``engine='local'``.

Both packages draw the same budgets and coordinate streams from the same
seed, so the runs are held round by round: every recorded dual, primal and
gap value, then the final W and Omega.  The solves differ only in float32
association, which stays at rounding level over these few rounds:
rtol 1e-5 / atol 1e-4 on the objectives (values of order 10-100), atol
1e-5 on W and Omega.  The simulated clock and the executed budgets come
from identical generators and must be equal.
"""
import numpy as np
import pytest
import torch

import repro.api as ja
import repro.core as jc
from repro.data.synthetic import FederationSpec as JSpec
from repro.data.synthetic import make_federation as jax_federation
from repro.data.synthetic import tiny_problem as jax_tiny
import repro_torch.api as ta
import repro_torch.core as tc
from repro_torch.convert import (federation_from_numpy, omega_from_numpy,
                                 state_from_numpy)
from repro_torch.data.synthetic import FederationSpec as TSpec
from repro_torch.data.synthetic import make_federation
from repro_torch.data.synthetic import tiny_problem

#: a carry-mode problem (d = 160 > the gram crossover)
CARRY = dict(name="carry", m=3, d=160, n_min=40, n_max=52, clusters=2,
             label_noise=0.0)


def _problems(kind):
    if kind == "tiny":
        return jax_tiny(seed=0)[0], tiny_problem(seed=0, device="cpu")[0]
    return (jax_federation(JSpec(**CARRY), seed=1)[0],
            make_federation(TSpec(**CARRY), seed=1, device="cpu")[0])


def _regs(name):
    kw = {"mean": dict(lambda1=0.5, lambda2=0.5),
          "clustered": dict(lam=1.0, eta=0.5, k=2),
          "probabilistic": dict()}[name]
    return jc.REGULARIZERS[name](**kw), tc.REGULARIZERS[name](**kw)


def _assert_runs_match(jrep, trep):
    jh, th = jrep.history, trep.history
    assert jh.keys() == th.keys() == set(tc.HISTORY_KEYS)
    assert jh["round"] == th["round"]
    assert jh["round_max_steps"] == th["round_max_steps"]
    np.testing.assert_array_equal(jh["time"], th["time"])
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(trep.result.W, np.asarray(jrep.result.W),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(trep.result.omega,
                               np.asarray(jrep.result.omega), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(trep.result.round_budgets,
                                  np.asarray(jrep.result.round_budgets))


def _run_both(kind, reg, engine, *, rounds=8, every=0, loss="hinge",
              systems=None, budget=None, seed=0):
    jdata, tdata = _problems(kind)
    jreg, treg = _regs(reg)
    bj = jc.BudgetConfig(**(budget or {}))
    bt = tc.BudgetConfig(**(budget or {}))
    sj = None if systems is None else jc.SystemsConfig(**systems)
    st = None if systems is None else tc.SystemsConfig(**systems)
    jrep = ja.Experiment(
        problem=ja.Problem(train=jdata),
        method=ja.Method(loss=loss, regularizers=(jreg,), rounds=rounds,
                         omega_update_every=every, budget=bj),
        systems=ja.Systems(config=sj)).run(seed)
    trep = ta.Experiment(
        problem=ta.Problem(train=tdata),
        method=ta.Method(loss=loss, regularizers=(treg,), rounds=rounds,
                         omega_update_every=every, budget=bt),
        systems=ta.Systems(config=st),
        exec=ta.Exec(engine=engine, device="cpu")).run(seed)
    return jrep, trep


@pytest.mark.parametrize("engine", ["local", "kernel"])
@pytest.mark.parametrize("kind", ["tiny", "carry"])
def test_run_matches_jax_with_omega_refresh(kind, engine):
    jrep, trep = _run_both(kind, "clustered", engine, every=3)
    _assert_runs_match(jrep, trep)
    assert trep.provenance["engine"] == engine
    assert trep.provenance["gram_mode"] == ("gram" if kind == "tiny"
                                            else "carry")


@pytest.mark.parametrize("engine", ["local", "kernel"])
def test_run_matches_jax_under_semi_sync(engine):
    systems = dict(policy="semi_sync", clock_cycle_s=1.2e-4, rate_lo=0.5,
                   rate_hi=1.5, straggler_prob=0.2, seed=3)
    jrep, trep = _run_both("tiny", "mean", engine, systems=systems,
                           budget=dict(systems_lo=0.3, drop_prob=0.1))
    _assert_runs_match(jrep, trep)
    assert (trep.result.round_budgets < 18).any()   # the caps did bite


@pytest.mark.parametrize("loss", ["smooth_hinge", "logistic", "squared"])
def test_local_engine_every_loss_matches_jax(loss):
    jrep, trep = _run_both("tiny", "probabilistic", "local", rounds=6,
                           every=2, loss=loss)
    _assert_runs_match(jrep, trep)


def test_jax_midrun_state_continues_in_the_port():
    """A JAX run's data, dual state and Omega, carried over as numpy, give
    the same continuation in the port as in the JAX package."""
    jdata, _ = _problems("tiny")
    jreg, treg = _regs("clustered")

    def jax_run(rounds, **kw):
        return ja.Experiment(
            problem=ja.Problem(train=jdata),
            method=ja.Method(regularizers=(jreg,), rounds=rounds,
                             omega_update_every=2,
                             omega0=kw.get("omega0")),
            exec=ja.Exec(state0=kw.get("state0"))).run(1)

    first = jax_run(4).result
    cont = jax_run(5, omega0=first.omega, state0=first.state)
    data = federation_from_numpy(np.asarray(jdata.X), np.asarray(jdata.y),
                                 np.asarray(jdata.mask), device="cpu")
    trep = ta.Experiment(
        problem=ta.Problem(train=data),
        method=ta.Method(regularizers=(treg,), rounds=5,
                         omega_update_every=2,
                         omega0=omega_from_numpy(first.omega, device="cpu")),
        exec=ta.Exec(engine="kernel", device="cpu",
                     state0=state_from_numpy(np.asarray(first.state.alpha),
                                             np.asarray(first.state.v),
                                             device="cpu"))).run(1)
    _assert_runs_match(cont, trep)


def test_run_cocoa_matches_jax():
    jdata, tdata = _problems("tiny")
    jreg, treg = _regs("mean")
    jres = jc.run_cocoa(jdata, jreg, jc.MochaConfig(
        rounds=5, budget=jc.BudgetConfig(passes=2.0, drop_prob=0.3)))
    tres = tc.run_cocoa(tdata, treg, tc.MochaConfig(
        rounds=5, budget=tc.BudgetConfig(passes=2.0, drop_prob=0.3),
        device="cpu"))
    np.testing.assert_allclose(tres.history["gap"], jres.history["gap"],
                               rtol=1e-5, atol=1e-4)
    # CoCoA strips the drops: every node runs its two full passes
    assert tres.round_budgets.min() == 36


def test_history_cadence_and_provenance():
    _, tdata = _problems("tiny")
    rep = ta.Experiment(problem=ta.Problem(train=tdata),
                        method=ta.Method(rounds=7),
                        exec=ta.Exec(device="cpu"),
                        eval=ta.Eval(record_every=3)).run(2)
    assert rep.history["round"] == [0, 3, 6]
    assert set(rep.provenance) == set(ta.PROVENANCE_KEYS)
    assert rep.provenance["device"] == "cpu"
    assert rep.provenance["path"] == "single"
    assert rep.final("gap") == rep.history["gap"][-1]
    assert isinstance(rep.result.state.alpha, torch.Tensor)
