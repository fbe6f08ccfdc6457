"""The SDCA kernel module of the port: its plain version against the JAX
package's kernel oracle, its coordinate draws against JAX's bit for bit,
and (on a card) the CUDA kernel against its plain version.

The JAX Pallas kernel cannot run in interpret mode under the installed JAX
(``pl.load`` is gone), so the port is held against the kernel's reference,
``repro.kernels.sdca.ref.sdca_ref``, which the JAX package pins bit-equal to
its kernel.  The two plain versions differ in the association of the chunk
reductions: atol 2e-6 on dalpha (bounded by 1) and u.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.subproblem import row_norms as jax_row_norms
from repro.kernels.sdca.ops import draw_coordinates as jax_draw
from repro.kernels.sdca.ref import sdca_ref as jax_sdca_ref
from repro_torch.core.dual import with_xnorm2
from repro_torch.core.losses import HINGE, SQUARED
from repro_torch.core.subproblem import batched_local_sdca
from repro_torch.data.synthetic import tiny_problem
from repro_torch.kernels import sdca as K
from repro_torch.utils import prng

SHAPES = [(3, 16, 8, 32), (4, 32, 100, 64), (2, 64, 16, 128),
          (1, 128, 50, 256), (2, 48, 150, 64)]


def _inputs(m, n, d, steps, seed=0, mask_tail=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    X = rng.normal(size=(m, n, d)).astype(f)
    y = np.sign(rng.normal(size=(m, n))).astype(f)
    mask = np.ones((m, n), f)
    if mask_tail:
        mask[:, n - mask_tail:] = 0.0
    alpha = np.zeros((m, n), f)
    W = (0.2 * rng.normal(size=(m, d))).astype(f)
    q = rng.uniform(0.5, 2.0, m).astype(f)
    budgets = rng.integers(0, steps, m).astype(np.int32)
    idx = rng.integers(0, n - mask_tail, (m, steps)).astype(np.int32)
    xn = np.array(jax_row_norms(jnp.asarray(X)))
    return [X, y, mask, alpha, W, q, budgets, idx, xn]


def _both(args, gram=None):
    *a, xn = args
    dj, uj = jax_sdca_ref(*(jnp.asarray(v) for v in a), gram=gram,
                          xnorm2=jnp.asarray(xn))
    dt, ut = K.sdca_ref(*(torch.from_numpy(v) for v in a), gram=gram,
                        xnorm2=torch.from_numpy(xn))
    return (dt.numpy(), np.asarray(dj)), (ut.numpy(), np.asarray(uj))


@pytest.mark.parametrize("m,n,d,steps", SHAPES)
def test_plain_version_matches_jax_oracle(m, n, d, steps):
    for got, want in _both(_inputs(m, n, d, steps)):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_plain_version_forced_gram_matches_jax_oracle():
    args = _inputs(2, 40, 120, 96, seed=1, mask_tail=0)
    args[6] = np.asarray([70, 96], np.int32)
    for got, want in _both(args, gram=True):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    args = [torch.from_numpy(v) for v in _inputs(4, 32, 100, 64, seed=2)]
    *a, xn = args
    K.reset_counts()
    da, u = K.sdca_local_solve(*a, 64, xnorm2=xn)
    dr, ur = K.sdca_ref(*a, xnorm2=xn)
    assert torch.equal(da, dr) and torch.equal(u, ur)
    assert K.COUNTS["sdca_local_solve"] == 0


def test_wrapper_zero_budget_is_noop():
    args = [torch.from_numpy(v) for v in _inputs(2, 16, 8, 32, seed=3)]
    args[6] = torch.zeros(2, dtype=torch.int32)
    da, u = K.sdca_local_solve(*args[:8], 32, xnorm2=args[8])
    assert not torch.any(da) and not torch.any(u)


def test_wrapper_refuses_other_devices():
    X = torch.empty((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.sdca_local_solve(X, *(None,) * 7, 8)


def test_draw_coordinates_bit_equal_to_jax():
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    n_t = np.asarray([7.0, 24.0, 1.0, 0.0, 13.0], np.float32)
    want = np.asarray(jax_draw(keys, jnp.asarray(n_t), 24, 61))
    got = K.draw_coordinates(torch.from_numpy(np.asarray(keys).astype(
        np.int64)), torch.from_numpy(n_t), 24, 61)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_local_sdca_matches_local_solver():
    """The kernel path draws the local solver's streams from the same keys,
    so on the CPU (where it runs the plain version) it is the same solve."""
    train = with_xnorm2(tiny_problem(m=4, n=24, d=6, seed=0,
                                     device="cpu")[0])
    keys = prng.split(prng.PRNGKey(3, device="cpu"), train.m)
    rng = np.random.default_rng(0)
    W = torch.from_numpy((0.1 * rng.normal(size=(4, 6))).astype(np.float32))
    q = torch.full((4,), 0.7)
    b = torch.tensor([18, 5, 0, 11], dtype=torch.int32)
    alpha = torch.zeros_like(train.y)
    da, u = K.kernel_local_sdca(train, alpha, W, q, b, keys, 18)
    dl, ul = batched_local_sdca(HINGE, train.X, train.y, train.mask, alpha,
                                W, q, b, keys, 18, xnorm2=train.xnorm2)
    assert torch.equal(da, dl) and torch.equal(u, ul)


def test_kernel_engine_is_hinge_only():
    from repro_torch.core.engine import KernelEngine
    train = tiny_problem(device="cpu")[0]
    with pytest.raises(ValueError, match="hinge"):
        KernelEngine().setup(train, SQUARED, 10)

