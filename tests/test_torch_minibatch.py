"""The mini-batch baselines (Mb-SGD, Mb-SDCA) of the port against the JAX
package's.  Both draw the same batches from the same seed (threefry, bit
equal), so the histories are held round by round: rtol 1e-5 / atol 1e-4 on
the objectives, atol 1e-5 on W, and the simulated clock equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.data.synthetic import FederationSpec as JSpec
from repro.data.synthetic import make_federation as jax_federation
import repro_torch.core as tc
from repro_torch.data.synthetic import FederationSpec as TSpec
from repro_torch.data.synthetic import make_federation

SPEC = dict(name="mb", m=4, d=8, n_min=20, n_max=40, clusters=2)


def _assert_match(t, j):
    assert t.history.keys() == j.history.keys()
    assert t.history["round"] == j.history["round"]
    np.testing.assert_array_equal(t.history["time"], j.history["time"])
    for k in t.history.keys() - {"round", "time"}:
        np.testing.assert_allclose(t.history[k], j.history[k], rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(t.W, np.asarray(j.W), atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["run_mb_sgd", "run_mb_sdca"])
@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge", "logistic",
                                  "squared"])
def test_minibatch_baseline_matches_jax(method, loss):
    jdata = jax_federation(JSpec(**SPEC), seed=0)[0]
    tdata = make_federation(TSpec(**SPEC), seed=0, device="cpu")[0]
    kw = dict(loss=loss, rounds=8, batch=6, lr=0.05, beta=3.0, seed=2,
              record_every=3)
    j = getattr(jc, method)(jdata, jc.MeanRegularized(lambda1=0.3),
                            jc.MiniBatchConfig(**kw))
    t = getattr(tc, method)(tdata, tc.MeanRegularized(lambda1=0.3),
                            tc.MiniBatchConfig(**kw))
    assert t.history["round"] == [0, 3, 6, 7]
    _assert_match(t, j)
    assert t.final("primal") == t.history["primal"][-1]


def test_minibatch_takes_an_omega():
    jdata = jax_federation(JSpec(**SPEC), seed=1)[0]
    tdata = make_federation(TSpec(**SPEC), seed=1, device="cpu")[0]
    omega = np.eye(4, dtype=np.float32) * 0.5 + 0.1
    cfg = dict(rounds=5, batch=8)
    _assert_match(
        tc.run_mb_sdca(tdata, tc.Probabilistic(lam=0.5),
                       tc.MiniBatchConfig(**cfg),
                       omega=torch.from_numpy(omega)),
        jc.run_mb_sdca(jdata, jc.Probabilistic(lam=0.5),
                       jc.MiniBatchConfig(**cfg), omega=jnp.asarray(omega)))
