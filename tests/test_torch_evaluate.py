"""Held-out evaluation of the port against the JAX package's, on the same
weights: JAX's own ``W`` carried across as numpy, so the error tables must
be equal and the mean losses within rtol 1e-6 (float32 reductions in
another order)."""
import numpy as np
import pytest

import repro.api as ja
import repro.core as jc
from repro.core.evaluate import evaluate_grid as jax_evaluate_grid
from repro.core.evaluate import evaluate_run as jax_evaluate_run
from repro.core.sweep import stack_federations as jax_stack
from repro.data.synthetic import FederationSpec as JSpec
from repro.data.synthetic import make_federation as jax_federation
import repro_torch.api as ta
import repro_torch.core as tc
from repro_torch.convert import federation_from_numpy

SPEC = dict(name="eval", m=4, d=6, n_min=12, n_max=30, clusters=2)


def _port(jdata):
    return federation_from_numpy(*(np.asarray(a) for a in jdata[:3]),
                                 device="cpu")


def _assert_reports_equal(t, j):
    assert t.per_client.keys() == j.per_client.keys()
    for k, v in j.per_client.items():
        if k == "loss":
            np.testing.assert_allclose(t.per_client[k], np.asarray(v),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t.per_client[k], np.asarray(v))
    assert t.summary.keys() == j.summary.keys()
    for k, v in j.summary.items():
        np.testing.assert_allclose(t.summary[k], v, rtol=1e-6, atol=0)
    if j.grid is not None:
        np.testing.assert_array_equal(t.grid, np.asarray(j.grid))


@pytest.mark.parametrize("loss", ["hinge", "logistic", "squared"])
def test_evaluate_run_matches_jax(loss):
    train, test = jax_federation(JSpec(**SPEC), seed=0)
    W = ja.Experiment(problem=ja.Problem(train=train),
                      method=ja.Method(loss=loss, rounds=4)).run(0).result.W
    for metrics in (("error", "loss"), ("error",), ("loss",)):
        _assert_reports_equal(
            tc.evaluate_run(np.asarray(W), _port(test), tc.get_loss(loss),
                            metrics),
            jax_evaluate_run(W, test, jc.get_loss(loss), metrics))
    with pytest.raises(ValueError, match="unknown eval metrics"):
        tc.evaluate_run(np.asarray(W), _port(test), tc.HINGE, ("auc",))


def test_evaluate_grid_matches_jax():
    splits = [jax_federation(JSpec(**SPEC), seed=s) for s in range(3)]
    regs = tuple(jc.Probabilistic(lam=lam) for lam in (0.01, 0.1))
    rep = ja.Experiment(
        problem=ja.Problem(train=[tr for tr, _ in splits]),
        method=ja.Method(regularizers=regs, rounds=4),
        exec=ja.Exec(engine="local", driver="loop")).run(0)
    W = np.asarray(rep.result.W)
    assert W.shape == (2, 3, 4, 6)
    test = jax_stack([te for _, te in splits])
    _assert_reports_equal(tc.evaluate_grid(W, _port(test), tc.HINGE),
                          jax_evaluate_grid(W, test, jc.HINGE))
    with pytest.raises(ValueError, match=r"\(R, S, m, d\)"):
        tc.evaluate_grid(W[0], _port(test), tc.HINGE)


def test_single_path_holdout_matches_evaluate_run():
    train, test = jax_federation(JSpec(**SPEC), seed=1)
    rep = ta.Experiment(problem=ta.Problem(train=_port(train)),
                        method=ta.Method(rounds=3),
                        exec=ta.Exec(device="cpu"),
                        eval=ta.Eval(holdout=_port(test))).run(0)
    _assert_reports_equal(
        rep.evaluation, jax_evaluate_run(rep.result.W, test, jc.HINGE))
    with pytest.raises(ValueError, match="single-problem holdout"):
        ta.Experiment(problem=ta.Problem(train=_port(train)),
                      method=ta.Method(rounds=1), exec=ta.Exec(device="cpu"),
                      eval=ta.Eval(holdout=[_port(test)])).run(0)
