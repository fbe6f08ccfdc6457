"""The port's pre-sampled ("scanned") driver.

Inside the port the scanned driver and the loop driver give the same bits:
the same keys and budgets, the same round arithmetic (the scanned round
also runs the dead chunks, which add exact zeros), the same metrics.  So
histories, W, Omega and the executed budgets are compared with equality.
Against the JAX package's ``driver="scan"`` on ``engine="local"`` the
runs are held within the parity contract: rtol 1e-5 / atol 1e-4 on the
objectives, atol 1e-5 on W and Omega, the clock and budgets equal.
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
from repro_torch.core.mocha import MochaConfig, _run_mocha
from repro_torch.core.subproblem import batched_local_sdca_idx
from repro_torch.data.synthetic import FederationSpec as TSpec
from repro_torch.data.synthetic import make_federation, tiny_problem
from repro_torch.utils import prng

CARRY = dict(name="carry", m=3, d=160, n_min=40, n_max=52, clusters=2,
             label_noise=0.0)
#: a clock tight enough that the semi_sync caps bind on the tiny problem
SEMI = dict(network="3g", policy="semi_sync", clock_cycle_s=1e-5,
            rate_lo=0.5, rate_hi=1.5, straggler_prob=0.2, seed=3)
LOSSES = ("hinge", "smooth_hinge", "logistic", "squared")


def _budget_fn(key, n_t, h):
    """Round-dependent budgets: half of them on odd rounds."""
    base = tc.round_budgets(tc.BudgetConfig(systems_lo=0.3), key, n_t)
    return base // (1 + h % 2)


#: the bit-parity cases: Method kwargs, Systems kwargs, history cadence
SETTINGS = {
    "sync_omega3_rec2_gamma05": dict(
        method=dict(omega_update_every=3, gamma=0.5), record_every=2),
    "semi_sync_drops": dict(
        method=dict(omega_update_every=2,
                    budget=tc.BudgetConfig(systems_lo=0.3, drop_prob=0.1)),
        systems=SEMI),
    "budget_fn": dict(method=dict(omega_update_every=3,
                                  budget_fn=_budget_fn)),
}


def _port_run(data, loss, driver, setting, reg=None, rounds=7, seed=0):
    s = SETTINGS[setting]
    systems = s.get("systems")
    return ta.Experiment(
        problem=ta.Problem(train=data),
        method=ta.Method(loss=loss, regularizers=(reg or tc.Clustered(k=2),),
                         rounds=rounds, **s["method"]),
        systems=ta.Systems(config=None if systems is None
                           else tc.SystemsConfig(**systems)),
        exec=ta.Exec(driver=driver, device="cpu"),
        eval=ta.Eval(record_every=s.get("record_every", 1))).run(seed)


def _assert_same_bits(a, b):
    assert a.history == b.history
    np.testing.assert_array_equal(a.result.W, b.result.W)
    np.testing.assert_array_equal(a.result.omega, b.result.omega)
    np.testing.assert_array_equal(a.result.round_budgets,
                                  b.result.round_budgets)
    for x, y in zip(a.result.state, b.result.state):
        assert torch.equal(x, y)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("loss", LOSSES)
def test_scan_matches_loop_bitwise(loss, setting):
    data = tiny_problem(m=4, n=24, d=6, seed=1, device="cpu")[0]
    loop = _port_run(data, loss, "loop", setting)
    scan = _port_run(data, loss, "scan", setting)
    assert (loop.provenance["driver"], scan.provenance["driver"]) == (
        "loop", "scan")
    _assert_same_bits(loop, scan)
    assert scan.result.capture_s is None       # the CPU runs eagerly
    if setting == "sync_omega3_rec2_gamma05":
        assert scan.history["round"] == [0, 2, 4, 6]


@pytest.mark.parametrize("setting", ["sync_omega3_rec2_gamma05",
                                     "semi_sync_drops"])
def test_scan_matches_loop_bitwise_in_carry_mode(setting):
    data = make_federation(TSpec(**CARRY), seed=1, device="cpu")[0]
    _assert_same_bits(_port_run(data, "hinge", "loop", setting),
                      _port_run(data, "hinge", "scan", setting))


def test_static_solve_gives_the_early_exit_bits():
    """The static-length solve (every chunk) against the early exit, with
    budgets ending mid-chunk, a dropped task and padded rows."""
    data = tc.with_xnorm2(tiny_problem(m=4, n=40, d=6, seed=2,
                                       device="cpu")[0])
    n = data.n_max
    mask = data.mask.clone()
    mask[2, n - 7:] = 0.0
    idx = tc.subproblem.draw_coordinates(
        prng.split(prng.PRNGKey(3), 4), mask.sum(-1), n, 200)
    W = 0.1 * torch.arange(24, dtype=torch.float32).reshape(4, 6)
    budgets = torch.tensor([17, 0, 45, 3], dtype=torch.int32)
    args = (tc.HINGE, data.X, data.y, mask, torch.zeros_like(mask), W,
            torch.tensor([0.5, 1.0, 2.0, 0.7]), budgets, idx, 200,
            data.xnorm2)
    for gram in (True, False):
        early = batched_local_sdca_idx(*args, gram)
        static = batched_local_sdca_idx(*args, gram, static=True)
        for a, b in zip(early, static):
            assert torch.equal(a, b)
        assert torch.equal(early[0][1], torch.zeros(n))


def _jax_vs_port(kind, reg_name, every=0, systems=None, budget=None,
                 loss="hinge"):
    if kind == "tiny":
        jdata, tdata = jax_tiny(seed=0)[0], tiny_problem(seed=0,
                                                         device="cpu")[0]
    else:
        jdata = jax_federation(JSpec(**CARRY), seed=1)[0]
        tdata = make_federation(TSpec(**CARRY), seed=1, device="cpu")[0]
    kw = {"clustered": dict(lam=1.0, eta=0.5, k=2),
          "probabilistic": dict(sigma2=10.0)}[reg_name]
    common = dict(loss=loss, rounds=7, omega_update_every=every)
    jrep = ja.Experiment(
        problem=ja.Problem(train=jdata),
        method=ja.Method(regularizers=(jc.REGULARIZERS[reg_name](**kw),),
                         budget=jc.BudgetConfig(**(budget or {})), **common),
        systems=ja.Systems(config=None if systems is None
                           else jc.SystemsConfig(**systems)),
        exec=ja.Exec(driver="scan")).run(0)
    trep = ta.Experiment(
        problem=ta.Problem(train=tdata),
        method=ta.Method(regularizers=(tc.REGULARIZERS[reg_name](**kw),),
                         budget=tc.BudgetConfig(**(budget or {})), **common),
        systems=ta.Systems(config=None if systems is None
                           else tc.SystemsConfig(**systems)),
        exec=ta.Exec(driver="scan", device="cpu")).run(0)
    assert jrep.provenance["driver"] == trep.provenance["driver"] == "scan"
    jh, th = jrep.history, trep.history
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
    return trep


@pytest.mark.parametrize("kind,reg,every,systems,budget,loss", [
    ("tiny", "clustered", 3, None, None, "hinge"),
    ("tiny", "probabilistic", 2, SEMI, dict(systems_lo=0.3, drop_prob=0.1),
     "hinge"),
    ("tiny", "probabilistic", 3, None, None, "logistic"),
    ("carry", "clustered", 3, None, None, "hinge"),
])
def test_scan_matches_jax_scan(kind, reg, every, systems, budget, loss):
    _jax_vs_port(kind, reg, every, systems, budget, loss)


def test_scan_on_the_kernel_engine_raises():
    data = tiny_problem(device="cpu")[0]
    with pytest.raises(ValueError, match="does not support the scanned"):
        ta.Experiment(problem=ta.Problem(train=data),
                      exec=ta.Exec(engine="kernel", driver="scan",
                                   device="cpu")).run(0)
    with pytest.raises(ValueError, match="does not support the scanned"):
        _run_mocha(data, tc.MeanRegularized(),
                   MochaConfig(engine="kernel", driver="scan", rounds=2,
                               device="cpu"))
    # auto keeps the kernel engine on the loop driver
    rep = ta.Experiment(problem=ta.Problem(train=data),
                        method=ta.Method(rounds=2),
                        exec=ta.Exec(engine="kernel", device="cpu")).run(0)
    assert rep.provenance["driver"] == "loop"
    assert rep.result.capture_s is None


def test_round_program_copies_inputs_and_never_rebinds():
    """``RoundProgram`` owns its buffers: ``set`` writes into the same
    tensors, and the caller's tensors are never written."""
    K = torch.eye(2)
    prog = tc.RoundProgram(lambda st, x: (st[0] + x["K"].sum(),),
                           (torch.zeros(()),), dict(K=K))
    buf = prog.inputs["K"]
    prog.run()
    prog.set(K=2 * torch.eye(2))
    prog.run()
    assert prog.inputs["K"] is buf
    assert torch.equal(K, torch.eye(2))
    assert float(prog.state[0]) == 6.0
