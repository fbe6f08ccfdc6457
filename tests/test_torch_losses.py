"""The port's losses against the JAX package's, elementwise.

Inputs are float32 grids that cross the clip boundaries (a*y at 0 and 1,
y*z at 1 and 1 - mu).  Closed forms agree to a few float32 ulps
(rtol 1e-6); logistic's 8-step Newton compounds a few roundings of log
and log1p per step (atol 1e-6 on deltas bounded by 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

NAMES = ["hinge", "smooth_hinge", "logistic", "squared"]


def _grid(seed=0, size=4000):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(size) < 0.5, -1.0, 1.0).astype(np.float32)
    a = (y * np.concatenate([rng.uniform(-0.2, 1.2, size - 4),
                             [0.0, 1.0, 0.5, 1e-7]])).astype(np.float32)
    z = rng.uniform(-3, 3, size).astype(np.float32)
    z[:3] = [1.0, 0.5, -1.0]
    xg = rng.normal(0, 2, size).astype(np.float32)
    qxx = rng.uniform(0, 5, size).astype(np.float32)
    qxx[:2] = 0.0
    return a, y, z, xg, qxx


@pytest.mark.parametrize("name", NAMES)
def test_value_and_conjugate(name):
    a, y, z, _, _ = _grid()
    J, T = jl.get_loss(name), tl.get_loss(name)
    t = torch.from_numpy
    np.testing.assert_allclose(T.value(t(z), t(y)).numpy(),
                               np.asarray(J.value(jnp.asarray(z),
                                                  jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        T.conjugate_neg(t(a), t(y)).numpy(),
        np.asarray(J.conjugate_neg(jnp.asarray(a), jnp.asarray(y))),
        rtol=1e-6, atol=1e-6)
    assert (T.mu, T.lipschitz) == (J.mu, J.lipschitz)


@pytest.mark.parametrize("name", NAMES)
def test_sdca_delta(name):
    a, y, _, xg, qxx = _grid(1)
    J, T = jl.get_loss(name), tl.get_loss(name)
    t = torch.from_numpy
    got = T.sdca_delta(t(a), t(y), t(xg), t(qxx)).numpy()
    want = np.asarray(J.sdca_delta(*(jnp.asarray(v)
                                     for v in (a, y, xg, qxx))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_get_loss_unknown():
    with pytest.raises(KeyError):
        tl.get_loss("nope")
