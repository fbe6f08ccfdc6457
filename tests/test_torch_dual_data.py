"""Synthetic federations (bit for bit) and the dual algebra of the port
against the JAX package.

The generators are numpy in both packages and consume the same draws, so
the arrays must be identical.  The objectives are float32 sums over a few
hundred terms taken in another order: rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual as jd
from repro.core.losses import get_loss as jax_loss
from repro.data import synthetic as js
from repro_torch.core import dual as td
from repro_torch.core.losses import get_loss
from repro_torch.data import synthetic as ts


def _assert_same(jdata, tdata):
    for a, b in zip((jdata.X, jdata.y, jdata.mask),
                    (tdata.X, tdata.y, tdata.mask)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", sorted(js.SPECS))
def test_make_federation_bit_equal(name):
    spec = js.SPECS[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(ts.SPECS[name])
    for jd_, td_ in zip(js.make_federation(spec, seed=3),
                        ts.make_federation(ts.SPECS[name], seed=3,
                                           device="cpu")):
        _assert_same(jd_, td_)


def test_difficulty_spread_and_tiny_problem():
    spec = dataclasses.replace(js.GOOGLE_GLASS, difficulty_spread=0.8, m=5)
    tspec = dataclasses.replace(ts.GOOGLE_GLASS, difficulty_spread=0.8, m=5)
    _assert_same(js.make_federation(spec, 1)[0],
                 ts.make_federation(tspec, 1, device="cpu")[0])
    _assert_same(js.tiny_problem(m=3, n=10, d=4, seed=2)[1],
                 ts.tiny_problem(m=3, n=10, d=4, seed=2, device="cpu")[1])


def _state(seed=0):
    jtr, jte = js.tiny_problem(m=4, n=24, d=6, seed=seed)
    ttr, tte = ts.tiny_problem(m=4, n=24, d=6, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    alpha = (np.asarray(jtr.y) * rng.uniform(0, 1, jtr.y.shape)
             * np.asarray(jtr.mask)).astype(np.float32)
    A = rng.normal(size=(4, 4)).astype(np.float32)
    abar = (A @ A.T + 4 * np.eye(4)).astype(np.float32)
    K = np.linalg.inv(abar).astype(np.float32)
    return (jtr, jte, ttr, tte, alpha, abar, K)


@pytest.mark.parametrize("loss", ["hinge", "logistic", "squared"])
def test_objectives_and_gap(loss):
    jtr, jte, ttr, tte, alpha, abar, K = _state()
    t, j = torch.from_numpy, jnp.asarray
    vj = jd.compute_v(jtr, j(alpha))
    vt = td.compute_v(ttr, t(alpha))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-6)
    Wj, Wt = jd.primal_weights(j(K), vj), td.primal_weights(t(K), vt)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=1e-5,
                               atol=1e-6)
    L, JL = get_loss(loss), jax_loss(loss)
    for fj, ft in (
            (jd.dual_objective(jtr, JL, j(K), j(alpha), vj),
             td.dual_objective(ttr, L, t(K), t(alpha), vt)),
            (jd.primal_objective(jtr, JL, j(abar), Wj),
             td.primal_objective(ttr, L, t(abar), Wt)),
            (jd.duality_gap(jtr, JL, j(abar), j(K), j(alpha), vj),
             td.duality_gap(ttr, L, t(abar), t(K), t(alpha), vt)),
            (jd.r_star(j(K), vj), td.r_star(t(K), vt))):
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        td.per_task_error(ttr, Wt, tte.X, tte.y, tte.mask).numpy(),
        np.asarray(jd.per_task_error(jtr, Wj, jte.X, jte.y, jte.mask)))


def test_state_containers_and_xnorm2():
    _, _, ttr, _, _, _, _ = _state()
    jtr = js.tiny_problem(m=4, n=24, d=6, seed=0)[0]
    st = td.init_state(ttr)
    assert st.alpha.shape == (4, 18) and st.v.shape == (4, 6)
    assert float(st.alpha.abs().sum()) == 0.0
    full = td.with_xnorm2(ttr)
    assert td.with_xnorm2(full) is full
    np.testing.assert_allclose(full.xnorm2.numpy(),
                               np.asarray(jd.with_xnorm2(jtr).xnorm2),
                               rtol=1e-6)
    assert (ttr.m, ttr.n_max, ttr.d) == (jtr.m, jtr.n_max, jtr.d)
    np.testing.assert_array_equal(ttr.n_t.numpy(), np.asarray(jtr.n_t))
