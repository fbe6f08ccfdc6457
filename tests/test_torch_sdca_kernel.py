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
from repro_torch.core.subproblem import (_solver_plan, batched_local_sdca,
                                         chunk_idx_stream)
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



# ---------------------------------------------------------------------------
# The card kernel's gram recurrence, modelled lane by lane on the CPU
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf in f32: the f64 product of two f32 values is exact, so one f32
    rounding of the f64 sum matches the card's fused multiply-add (up to a
    double rounding of the sum, which these sizes do not meet)."""
    return (a.double() * b.double() + c.double()).float()


def _gram_lane_model(X, y, mask, alpha, W, q, budget, idx, max_steps, xn):
    """One task through the recurrence of ``csrc/sdca.cu``'s gram mode.

    Lane k of the chain warp owns step k of a chunk: it keeps
    ``acc_k = sum_{j<k} G_kj delta_j`` (one fused multiply-add after each
    step, in step order) and its coordinate's running dalpha, to which it
    adds the deltas of the earlier lanes with the same coordinate; at step
    k it forms g_k = p_k + q acc_k and its delta, which every lane then
    sees.  dalpha is written back once per coordinate by its last lane."""
    n, d = X.shape
    _, C = _solver_plan(d, max_steps, True)
    chunks = chunk_idx_stream(idx.long(), max_steps, C)
    budget = min(int(budget), max_steps)
    live_chunks = 0 if budget <= 0 else min(chunks.shape[0], -(-budget // C))
    dalpha = torch.zeros(n)
    u, r = torch.zeros(d), W.clone()
    for c in range(live_chunks):
        ic = chunks[c].tolist()
        Xc = X[ic]
        G, p = Xc @ Xc.T, Xc @ r
        da = [dalpha[i].clone() for i in ic]     # lane k's running dalpha
        acc = torch.zeros(C)
        deltas = torch.zeros(C)
        for s, i in enumerate(ic):
            g = p[s] + q * acc[s]
            live = float(c * C + s < budget and mask[i] > 0)
            delta = HINGE.sdca_delta(alpha[i] + da[s], y[i], g,
                                     q * xn[i]) * live
            deltas[s] = delta
            acc = _fma(G[:, s], delta.expand(C), acc)
            for k in range(s + 1, C):
                if ic[k] == i:
                    da[k] = da[k] + delta
        for k, i in enumerate(ic):
            if i not in ic[k + 1:]:
                dalpha[i] = da[k] + deltas[k]
        colsum = torch.sum(Xc * deltas[:, None], dim=0)
        u, r = u + colsum, r + q * colsum
    return dalpha, u


@pytest.mark.parametrize("m,n,d,steps,dup", [
    (3, 16, 8, 32, 3), (2, 40, 100, 70, 5), (3, 50, 20, 100, None),
    (2, 30, 12, 5, 2), (2, 90, 64, 90, 11)])
def test_gram_lane_model_matches_plain_version(m, n, d, steps, dup):
    """The lane-by-lane recurrence gives the plain version's solve: each
    step's g from a running per-lane sum instead of a fresh dot with the
    chunk's deltas, and repeated coordinates resolved in step order.  The
    streams repeat coordinates inside chunks and across them (``dup``) and
    budgets end mid-chunk.  The g sums are associated differently: atol
    1e-5 on dalpha (bounded by 1) and u."""
    X, y, mask, alpha, W, q, budgets, idx, xn = (
        torch.from_numpy(v) for v in _inputs(m, n, d, steps, seed=5))
    if dup is not None:
        idx = idx % dup
        chunk = _solver_plan(d, steps, True)[1]
        assert any(len(set(c)) < len(c) for c in chunk_idx_stream(
            idx.long(), steps, chunk)[0].tolist())
    alpha = y * mask * torch.rand(m, n, generator=torch.Generator()
                                  .manual_seed(0))
    dr, ur = K.sdca_ref(X, y, mask, alpha, W, q, budgets, idx, gram=True,
                        xnorm2=xn)
    for t in range(m):
        dm, um = _gram_lane_model(X[t], y[t], mask[t], alpha[t], W[t], q[t],
                                  budgets[t], idx[t], steps, xn[t])
        torch.testing.assert_close(dm, dr[t], atol=1e-5, rtol=0)
        torch.testing.assert_close(um, ur[t], atol=1e-5, rtol=0)
