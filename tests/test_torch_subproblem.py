"""The port's plain SDCA solver against the JAX package's ``local_sdca_idx``.

Both run arithmetic version 2 over the same explicit coordinate stream and
the same row-norm table; they differ only in the association of the
chunk's reductions, so each solve agrees to float32 rounding: atol 2e-6 on
dalpha (|dalpha| <= 1 for the bounded losses) and u.  Budget 0 and mask 0
must be exact no-ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro.core import subproblem as js
from repro_torch.core import losses as tl
from repro_torch.core import subproblem as ts
from repro_torch.utils import prng

NAMES = ["hinge", "smooth_hinge", "logistic", "squared"]
#: the shapes of tests/test_kernels.py (both residual modes of the plan)
SHAPES = [(3, 16, 8, 32), (4, 32, 100, 64), (2, 64, 16, 128),
          (1, 128, 50, 256), (2, 48, 150, 64)]


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(m, n, d, steps, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    X = rng.normal(size=(m, n, d)).astype(f)
    y = np.sign(rng.normal(size=(m, n))).astype(f)
    mask = np.ones((m, n), f)
    mask[:, n - 3:] = 0.0
    alpha = (y * rng.uniform(0, 0.5, (m, n)) * mask).astype(f)
    W = (0.2 * rng.normal(size=(m, d))).astype(f)
    q = rng.uniform(0.5, 2.0, m).astype(f)
    budgets = rng.integers(0, steps, m).astype(np.int32)
    idx = rng.integers(0, n - 3, (m, steps)).astype(np.int32)
    xn = np.array(js.row_norms(jnp.asarray(X)))
    return X, y, mask, alpha, W, q, budgets, idx, xn


def _jax_solve(name, args, steps, gram=None):
    fn = jax.jit(jax.vmap(
        lambda X, y, m, a, w, q, b, i, xn: js.local_sdca_idx(
            jl.get_loss(name), X, y, m, a, w, q, b, i, steps, xn, gram)))
    return [np.asarray(o) for o in fn(*(jnp.asarray(a) for a in args))]


def _torch_solve(name, args, steps, gram=None):
    X, y, mask, alpha, W, q, b, idx, xn = (_t(a) for a in args)
    d, u = ts.batched_local_sdca_idx(tl.get_loss(name), X, y, mask, alpha,
                                     W, q, b, idx, steps, xn, gram)
    return d.numpy(), u.numpy()


@pytest.mark.parametrize(
    "name,m,n,d,steps",
    [("hinge",) + s for s in SHAPES]
    + [(name,) + s for name in NAMES[1:] for s in (SHAPES[1], SHAPES[4])])
def test_local_sdca_idx_matches_jax(name, m, n, d, steps):
    args = _inputs(m, n, d, steps)
    for got, want in zip(_torch_solve(name, args, steps),
                         _jax_solve(name, args, steps)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_single_task_entry_matches_batched():
    args = _inputs(2, 32, 100, 64, seed=4)
    dB, uB = _torch_solve("hinge", args, 64)
    t = [_t(a[1]) for a in args]
    d1, u1 = ts.local_sdca_idx(tl.HINGE, *t[:8], 64, t[8])
    np.testing.assert_array_equal(d1.numpy(), dB[1])
    np.testing.assert_array_equal(u1.numpy(), uB[1])


@pytest.mark.parametrize("gram", [True, False])
def test_forced_mode_matches_jax(gram):
    """gram=True at d=120 mirrors the kernel tests' forced Gram case;
    gram=False at d=150 is the default carry mode, forced explicitly."""
    d = 120 if gram else 150
    args = _inputs(2, 40, d, 96, seed=1)
    for got, want in zip(_torch_solve("hinge", args, 96, gram),
                         _jax_solve("hinge", args, 96, gram)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("d", [8, 150])
def test_budget_zero_and_mask_zero_are_exact_noops(d):
    X, y, mask, alpha, W, q, b, idx, xn = _inputs(2, 16, d, 32)
    for b_, mask_ in ((np.zeros_like(b), mask), (b + 5, np.zeros_like(mask))):
        dalpha, u = _torch_solve(
            "hinge", (X, y, mask_, alpha, W, q, b_, idx, xn), 32)
        assert not np.any(dalpha) and not np.any(u)


def test_plan_and_layout_match_jax(monkeypatch):
    for d in (8, 100, 128, 129, 511, 512, 561):
        for steps in (1, 7, 64, 1000):
            assert ts._solver_plan(d, steps) == js._solver_plan(d, steps)
            assert (ts._solver_plan(d, steps, gram=True)
                    == js._solver_plan(d, steps, gram=True))
    monkeypatch.setenv("REPRO_GRAM_MAX_D", "600")
    assert ts._solver_plan(561, 300) == js._solver_plan(561, 300) == (True,
                                                                        32)
    assert ts.resolve_gram(100, 64) is js.resolve_gram(100, 64) is False
    idx = np.arange(2 * 37, dtype=np.int32).reshape(2, 37)
    np.testing.assert_array_equal(
        ts.chunk_idx_stream(torch.from_numpy(idx), 37, 16).numpy(),
        np.asarray(js.chunk_idx_stream(jnp.asarray(idx), 37, 16)))


def test_key_driven_solves_match_jax():
    """Keyed entry points draw the JAX package's coordinate streams."""
    X, y, mask, alpha, W, q, b, idx, xn = _inputs(3, 24, 6, 40, seed=2)
    kj = jax.random.split(jax.random.PRNGKey(5), 3)
    kt = torch.from_numpy(np.asarray(kj).astype(np.int64))
    j = jnp.asarray
    dj, uj = js.batched_local_sdca(jl.HINGE, j(X), j(y), j(mask), j(alpha),
                                   j(W), j(q), j(b), kj, 40, j(xn))
    t = _t
    dt, ut = ts.batched_local_sdca(tl.HINGE, t(X), t(y), t(mask), t(alpha),
                                   t(W), t(q), t(b), kt, 40, t(xn))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-6)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=2e-6)
    d1, u1 = ts.local_sdca(tl.HINGE, t(X[0]), t(y[0]), t(mask[0]),
                           t(alpha[0]), t(W[0]), t(q[0]), t(b[0]), kt[0], 40)
    np.testing.assert_allclose(d1.numpy(), np.asarray(dj[0]), atol=2e-6)


def test_subproblem_value_and_theta_match_jax():
    """theta compares ratios of subproblem values after 64 exact passes:
    atol 1e-4 on a quantity in [0, 1]."""
    X, y, mask, alpha, W, q, b, idx, xn = _inputs(1, 20, 6, 20, seed=3)
    j, t = jnp.asarray, _t
    key_j = jax.random.PRNGKey(1)
    key_t = prng.PRNGKey(1, device="cpu")
    dj, _ = js.local_sdca(jl.HINGE, j(X[0]), j(y[0]), j(mask[0]),
                          j(alpha[0]), j(W[0]), j(q[0]), j(10), key_j, 20)
    dt = _t(dj)
    for fj, ft in (
            (js.subproblem_value(jl.HINGE, j(X[0]), j(y[0]), j(mask[0]),
                                 j(alpha[0]), dj, j(W[0]), j(q[0])),
             ts.subproblem_value(tl.HINGE, t(X[0]), t(y[0]), t(mask[0]),
                                 t(alpha[0]), dt, t(W[0]), t(q[0]))),
            (js.measure_theta(jl.HINGE, j(X[0]), j(y[0]), j(mask[0]),
                              j(alpha[0]), j(W[0]), j(q[0]), dj, key_j,
                              exact_passes=8),
             ts.measure_theta(tl.HINGE, t(X[0]), t(y[0]), t(mask[0]),
                              t(alpha[0]), t(W[0]), t(q[0]), dt, key_t,
                              exact_passes=8))):
        np.testing.assert_allclose(float(ft), float(fj), atol=1e-4)
