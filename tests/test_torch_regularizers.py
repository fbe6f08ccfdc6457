"""The port's regularizers against the JAX package's: coupling, K, the
Omega update and sigma'.

Matrices are compared, never eigenvectors (their signs and order differ
between eigensolvers).  Closed forms agree to float32 rounding of an m x m
eigendecomposition (atol 1e-5 on entries of order 1); Graphical runs 25
ISTA steps, each through an eigendecomposition (atol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regularizers as jr
from repro_torch.core import regularizers as tr

M, D = 5, 7


def _W(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(M, D))).astype(np.float32)


def _pair(name):
    kw = {"mean": dict(lambda1=0.5, lambda2=0.7),
          "clustered": dict(lam=0.8, eta=0.4, k=2),
          "probabilistic": dict(lam=1.2, sigma2=0.5),
          "graphical": dict(lam=1.0, lam2=0.02)}[name]
    return jr.REGULARIZERS[name](**kw), tr.REGULARIZERS[name](**kw)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(jr.REGULARIZERS))
def test_init_coupling_and_K(name):
    J, T = _pair(name)
    oj, ot = J.init_omega(M), T.init_omega(M, device="cpu")
    _close(ot, oj, 1e-6)
    _close(T.coupling(ot), J.coupling(oj), 1e-5)
    _close(T.K(ot), J.K(oj), 1e-5)
    W = _W()
    np.testing.assert_allclose(float(T.penalty(torch.from_numpy(W), ot)),
                               float(J.penalty(jnp.asarray(W), oj)),
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(jr.REGULARIZERS))
def test_update_omega(name):
    J, T = _pair(name)
    atol = 1e-4 if name == "graphical" else 1e-5
    oj, ot = J.init_omega(M), T.init_omega(M, device="cpu")
    for seed in (0, 1):
        W = _W(seed)
        uj = J.update_omega(jnp.asarray(W), oj)
        ut = T.update_omega(torch.from_numpy(W), ot)
        _close(ut, uj, atol)
        _close(T.coupling(ut), J.coupling(uj), 10 * atol)


@pytest.mark.parametrize("name", ["clustered", "probabilistic"])
def test_update_omega_cold_start_keeps_prior(name):
    J, T = _pair(name)
    zero = np.zeros((M, D), np.float32)
    _close(T.update_omega(torch.from_numpy(zero), T.init_omega(M, "cpu")),
           J.update_omega(jnp.asarray(zero), J.init_omega(M)), 1e-6)


@pytest.mark.parametrize("per_task", [True, False])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_sigma_prime_and_spd_inverse(per_task, gamma):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(M, M)).astype(np.float32)
    S = (A @ A.T + np.eye(M)).astype(np.float32)
    _close(tr.spd_inverse(torch.from_numpy(S)), jr.spd_inverse(jnp.asarray(S)),
           1e-4)
    Kj = jr.spd_inverse(jnp.asarray(S))
    Kt = torch.from_numpy(np.array(Kj))
    _close(tr.sigma_prime(Kt, gamma, per_task),
           jr.sigma_prime(Kj, gamma, per_task), 1e-5)


def test_init_omega_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.MeanRegularized().init_omega(3)
