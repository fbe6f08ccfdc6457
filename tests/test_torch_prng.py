"""The port's threefry PRNG against jax.random, bit for bit.

Every coordinate and budget draw of a run comes from these functions, so
whole runs of the port can be held to the JAX package round by round only
if they are exact: the tolerance is zero.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.theta import round_key_schedule as jax_key_schedule
from repro_torch.core.theta import round_key_schedule
from repro_torch.utils import prng

SEEDS = [0, 1, 7, 4242, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def _np(t):
    return t.numpy().astype(np.uint32) if t.dtype == torch.int64 else t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(np.asarray(kj), _np(kt))
    for num in (1, 2, 3, 5, 23, 30):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, num)),
                                      _np(prng.split(kt, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (100,), (3, 5), (1450,)])
def test_uniform_and_bernoulli(seed, shape):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                  prng.uniform(kt, shape).numpy())
    for p in (0.05, 0.3, 0.9):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(kj, p, shape)),
            prng.bernoulli(kt, p, shape).numpy())


def test_batched_keys_match_vmap():
    """A (m, 2) key batch draws what ``vmap`` over keys draws (the per-task
    coordinate streams of a round)."""
    kj = jax.random.split(jax.random.PRNGKey(3), 6)
    kt = torch.from_numpy(np.asarray(kj).astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (37,)))(kj)),
        prng.uniform(kt, (37,)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(kj)),
        _np(prng.split(kt, 4)))


def test_round_key_schedule():
    bj, rj = jax_key_schedule(jax.random.PRNGKey(11), 9)
    bt, rt = round_key_schedule(prng.PRNGKey(11, device="cpu"), 9)
    np.testing.assert_array_equal(np.asarray(bj), _np(bt))
    np.testing.assert_array_equal(np.asarray(rj), _np(rt))


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1, device="cpu")
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 32, device="cpu")
