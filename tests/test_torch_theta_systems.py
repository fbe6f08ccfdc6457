"""Step budgets and the simulated systems clock of the port against the
JAX package's, exactly: both draw from the same generators (threefry for
budgets, PCG64 for the clock), so budgets, caps and times must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import systems_model as jsm
from repro.core import theta as jt
from repro_torch.core import systems_model as tsm
from repro_torch.core import theta as tt
from repro_torch.utils import prng

N_T = np.asarray([18, 40, 7, 25, 31, 12], np.float32)
CONFIGS = [
    dict(),
    dict(passes=2.5),
    dict(systems_lo=0.1, systems_hi=1.0),
    dict(systems_lo=0.5),
    dict(drop_prob=0.3),
    dict(passes=0.5, systems_lo=0.2, systems_hi=0.9, drop_prob=0.2),
]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_round_budgets_bit_equal(kw):
    cj, ct = jt.BudgetConfig(**kw), tt.BudgetConfig(**kw)
    assert ct.max_steps(40) == cj.max_steps(40)
    for seed in range(8):
        kj, kt = _keys(seed)
        got = tt.round_budgets(ct, kt, torch.from_numpy(N_T))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jt.round_budgets(cj, kj,
                                                     jnp.asarray(N_T))))


def test_never_send_node_and_assumption2():
    cj = jt.BudgetConfig(never_send_node=2)
    ct = tt.BudgetConfig(never_send_node=2)
    kj, kt = _keys(1)
    with pytest.warns(UserWarning):
        tt.validate_assumption2(ct)
    np.testing.assert_array_equal(
        tt.round_budgets(ct, kt, torch.from_numpy(N_T)).numpy(),
        np.asarray(jt.round_budgets(cj, kj, jnp.asarray(N_T))))
    with pytest.raises(ValueError, match="Assumption 2"):
        tt.validate_assumption2(tt.BudgetConfig(drop_prob=1.0))


def test_presampled_and_drop_masked_budgets():
    cfg_j = jt.BudgetConfig(systems_lo=0.3, drop_prob=0.1)
    cfg_t = tt.BudgetConfig(systems_lo=0.3, drop_prob=0.1)
    kj, kt = _keys(4)
    bkj, _ = jt.round_key_schedule(kj, 7)
    bkt, _ = tt.round_key_schedule(kt, 7)
    n_j, n_t = jnp.asarray(N_T), torch.from_numpy(N_T)
    np.testing.assert_array_equal(
        tt.presample_budgets(cfg_t, bkt, n_t).numpy(),
        np.asarray(jt.presample_budgets(cfg_j, bkj, n_j)))
    dropped = np.random.default_rng(0).random((7, 6)) < 0.4
    fj = jt.drop_masked_budgets(cfg_j, dropped)
    ft = tt.drop_masked_budgets(cfg_t, dropped)
    for h in range(7):
        np.testing.assert_array_equal(ft(bkt[h], n_t, h).numpy(),
                                      np.asarray(fj(bkj[h], n_j, h)))


@pytest.mark.parametrize("policy", ["sync", "semi_sync"])
def test_systems_trace_matches(policy):
    kw = dict(policy=policy, rate_lo=0.5, rate_hi=1.5, straggler_prob=0.2,
              comm_jitter=0.3, seed=5, network="3g")
    if policy == "semi_sync":
        kw["clock_cycle_s"] = 2e-4
    cj, ct = jsm.SystemsConfig(**kw), tsm.SystemsConfig(**kw)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    trj, trt = jsm.SystemsTrace(6, 10, cj), tsm.SystemsTrace(6, 10, ct)
    pj, pt = trj.presample_caps(4), trt.presample_caps(4)
    assert (pj is None) == (pt is None)
    if pj is not None:
        np.testing.assert_array_equal(pj, pt)
    steps = np.random.default_rng(1).integers(0, 40, (4, 6))
    for row in steps:
        cap_j, cap_t = trj.begin_round(), trt.begin_round()
        if cap_j is not None:
            np.testing.assert_array_equal(cap_j, cap_t)
        assert trj.commit(row) == trt.commit(row)
    np.testing.assert_array_equal(trj.times(), trt.times())
    assert trj.summary() == trt.summary()
    np.testing.assert_array_equal(
        jsm.population_rates(50, cj), tsm.population_rates(50, ct))
