"""The plain reference of MOCHA (Smith et al. 2017, Algorithm 1) that
decides ``correct``.

It solves the same (regularizer x shuffle) grid as the program, from the
same federations, and works out again everything the program derives from
them: the driver's key chain and each task's coordinate stream (JAX's
``threefry2x32`` in its partitionable layout, which the program reproduces
bit for bit), the step budgets, W(alpha) = K V / 2, every SDCA step, the
Omega refreshes of the probabilistic regularizer (paper eq. 14), the final
objectives and the held-out predictions.  It imports nothing of the
program and runs plain ``torch`` operations:

  * SDCA is written step by step: g = <x_i, w_t + q_t u_t>, the hinge's
    closed-form increment, then u_t += delta x_i.  It follows no chunk
    plan and no Gram window; those are the program's rewrites of the same
    sequence of steps;
  * ``precision="float64"`` is the reference;  ``precision="tf32"`` is the
    control: float32, with the operands of every product (dot products,
    matrix products) rounded to TF32's 10-bit mantissa, as a tensor core
    in TF32 mode rounds them;  ``precision="float32"`` is the reference in
    the program's own precision, a witness of what float32 alone does.

The definitions the program's regularizer states (eigenvalue floors of
1e-10 and 1e-6, the 1e-8 trace guard, sigma'_t of Remark 5, the
1e-12 divisor clamp) are part of the method and are copied here; where
they came from is named beside each.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# --------------------------------------------------------------------------
# threefry2x32 (Salmon et al. 2011, 20 rounds), JAX's key layout
# --------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, c0, c1):
    """The 2x32 hash of counters (c0, c1) under key (k0, k1); uint32 words
    held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (c0 + k0) & _U32, (c1 + k1) & _U32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _hash_counts(keys, count: int):
    """Hash the counters 0..count-1 (high word 0) under every key of
    ``keys`` (..., 2): two (..., count) words."""
    c1 = torch.arange(count, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    return _threefry(k0, k1, torch.zeros_like(c1), c1)


def split_keys(keys, num: int):
    """``jax.random.split`` of every key: (..., 2) -> (..., num, 2)."""
    return torch.stack(_hash_counts(keys, num), dim=-1)


def uniform01(keys, count: int):
    """``jax.random.uniform`` on [0, 1) in float32: (..., 2) -> (..., count)."""
    b0, b1 = _hash_counts(keys, count)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# --------------------------------------------------------------------------
# arithmetic in the chosen precision
# --------------------------------------------------------------------------


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa), to nearest, ties away."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class _Arith:
    def __init__(self, precision: str):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.round = _tf32 if precision == "tf32" else (lambda x: x)

    def mm(self, a, b):
        return torch.matmul(self.round(a), self.round(b))

    def dot(self, a, b):
        return torch.sum(self.round(a) * self.round(b), dim=-1)


def _sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def _eig_fn(ar: _Arith, a, fn):
    """Q fn(w) Q^T of a symmetric batch."""
    w, q = torch.linalg.eigh(_sym(a))
    return ar.mm(q * fn(w)[..., None, :], q.transpose(-1, -2))


def _coupling(ar: _Arith, omega, lam, sigma2: float):
    """Probabilistic regularizer (eq. 14): Abar = lam (Omega^-1 + I /
    sigma2), Omega inverted with eigenvalues floored at 1e-6
    (regularizers.py ``Probabilistic.coupling``); K = Abar^-1; the per-task
    sigma'_t = sum_t' |K_tt'| / max(K_tt, 1e-8) (Remark 5, gamma 1) and
    q_t = sigma'_t K_tt / 2 (mocha.py ``_coupling_terms``)."""
    m = omega.shape[-1]
    eye = torch.eye(m, dtype=omega.dtype, device=omega.device)
    inv = _eig_fn(ar, omega, lambda w: 1.0 / torch.clamp_min(w, 1e-6))
    abar = lam[:, None, None] * (inv + eye / sigma2)
    K = torch.linalg.inv(abar)
    diag = torch.diagonal(K, dim1=-2, dim2=-1)
    sig = torch.sum(torch.abs(K), dim=-1) / torch.clamp_min(diag, 1e-8)
    return abar, K, sig * diag / 2.0


def _omega_step(ar: _Arith, W):
    """Omega <- (W W^T)^(1/2) / tr(.), the square root with eigenvalues
    floored at 1e-10; I / m while the trace is under 1e-8 (cold start)
    (regularizers.py ``Probabilistic.update_omega``)."""
    m = W.shape[-2]
    root = _eig_fn(ar, ar.mm(W, W.transpose(-1, -2)),
                   lambda w: torch.sqrt(torch.clamp_min(w, 1e-10)))
    tr = torch.diagonal(root, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    eye = torch.eye(m, dtype=W.dtype, device=W.device) / m
    return torch.where(tr > 1e-8, root / torch.clamp_min(tr, 1e-8), eye)


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------


class _StepLoop:
    """A round's SDCA steps over every task of every cell, one after
    another.  On the card the loop, the same operations on buffers of fixed
    shape every round, runs eagerly in the first round and is then captured
    once as a CUDA graph and replayed, so that the reference is not paced
    by the host's launches; on the CPU it runs eagerly."""

    def __init__(self, ar: _Arith, n: int):
        self.ar, self.n = ar, n
        self.graph = None
        self.bufs = None
        self.rounds = 0

    def _steps(self, xs, ys, yl, inv_qxx, a0, idx, r, qt, dalpha, deltas):
        for s in range(idx.shape[-1]):
            i = idx[:, :, s:s + 1]
            x = xs[:, s]
            a = a0[:, :, s] + torch.gather(dalpha, 2, i)[..., 0]
            g = self.ar.dot(x, r)
            # hinge: the increment of a y, clamped to [0, 1]
            ay = a * ys[:, s]
            new = torch.clamp(ay + (1.0 - ys[:, s] * g) * inv_qxx[:, :, s],
                              0.0, 1.0)
            delta = (new - ay) * yl[:, s]
            dalpha.scatter_add_(2, i, delta[..., None])
            r.addcmul_((qt * delta)[..., None], x)
            deltas[:, :, s] = delta

    def run(self, xs, ys, yl, inv_qxx, a0, idx, W, qt):
        """(dalpha, deltas) of one round from its gathered rows and the
        round-start weights W."""
        R, SM, steps = idx.shape
        inputs = (xs, ys, yl, inv_qxx, a0, idx, W, qt)
        self.rounds += 1
        if xs.device.type != "cuda" or self.rounds == 1:
            dalpha = torch.zeros((R, SM, self.n), dtype=W.dtype,
                                 device=W.device)
            deltas = torch.zeros((R, SM, steps), dtype=W.dtype,
                                 device=W.device)
            self._steps(xs, ys, yl, inv_qxx, a0, idx, W.clone(), qt, dalpha,
                        deltas)
            return dalpha, deltas
        if self.graph is None:
            self.bufs = [t.clone() for t in inputs] + [
                torch.zeros((R, SM, self.n), dtype=W.dtype, device=W.device),
                torch.zeros((R, SM, steps), dtype=W.dtype, device=W.device)]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._steps(*self.bufs[:6], self.bufs[6], self.bufs[7],
                            self.bufs[8], self.bufs[9])
        for buf, t in zip(self.bufs, inputs):
            buf.copy_(t)        # W is copied into r, the residual buffer
        self.bufs[8].zero_()
        self.graph.replay()
        return self.bufs[8].clone(), self.bufs[9].clone()


def solve(train, lams: Sequence[float], sigma2: float, rounds: int,
          omega_every: int, passes: float, seeds: Sequence[int],
          precision: str = "float64") -> Dict[str, np.ndarray]:
    """Run MOCHA with hinge loss on every (lambda, shuffle) cell.

    ``train``: stacked shuffles (X (S, m, n, d), y, mask), as the
    generator makes them.  ``seeds``: the driver seed of each shuffle.
    Returns numpy arrays: W (R, S, m, d), omega (R, S, m, m), primal and
    dual (R, S) after the last round, budgets (S, rounds, m).
    """
    ar = _Arith(precision)
    dt, dev = ar.dtype, train.X.device
    S, m, n, d = train.X.shape
    R, SM = len(lams), S * m
    X = train.X.to(dt).reshape(SM, n, d)
    y = train.y.to(dt).reshape(SM, n)
    mask = train.mask.reshape(SM, n)
    n_t = torch.sum(train.mask, dim=-1)                     # (S, m) float32
    xn2 = torch.sum(X * X, dim=-1)                          # (SM, n)
    lam = torch.tensor(lams, dtype=dt, device=dev).repeat_interleave(S)

    # budgets: ``passes`` passes over each task's points, at least one
    # step, at most the padded length's (theta.py ``round_budgets``,
    # ``BudgetConfig.max_steps``); no systems draws, no drops
    max_steps = max(1, int(round(passes * n)))
    budgets = torch.clamp(torch.round(passes * n_t).to(torch.int64), 1,
                          max_steps).reshape(SM)
    steps = int(budgets.max())

    omega = torch.eye(m, dtype=dt, device=dev).expand(R * S, m, m) / m
    abar, K, q = _coupling(ar, omega, lam, sigma2)
    alpha = torch.zeros((R, SM, n), dtype=dt, device=dev)
    v = torch.zeros((R, SM, d), dtype=dt, device=dev)
    rows = torch.arange(SM, device=dev)[:, None]
    keys = torch.tensor([[0, int(s)] for s in seeds], dtype=torch.int64,
                        device=dev)
    loop = _StepLoop(ar, n)

    def by_cell(t):      # (R, SM, ...) <-> (R*S, m, ...)
        return t.reshape(R * S, m, *t.shape[2:])

    for h in range(rounds):
        # the driver's chain: key, k_budget, k_round = split(key, 3); one
        # key a task from k_round (mocha.py ``_run_loop``)
        keys, _, k_round = split_keys(keys, 3).unbind(-2)
        task_keys = split_keys(k_round, m)                   # (S, m, 2)
        u01 = uniform01(task_keys, steps)                   # (S, m, steps)
        # the coordinate draw, in float32 as the stream defines it
        idx = (u01 * torch.clamp_min(n_t, 1.0)[..., None]).to(torch.int64)
        idx = torch.clamp_max(idx, n - 1).reshape(SM, steps)

        W = 0.5 * ar.mm(K, by_cell(v)).reshape(R, SM, d)
        qt = q.reshape(R, SM)
        xs = X[rows, idx]                                   # (SM, steps, d)
        ys = y[rows, idx]
        live = (torch.arange(steps, device=dev) < budgets[:, None]) & (
            mask[rows, idx] > 0)
        yl = ys * live.to(dt)
        inv_qxx = 1.0 / torch.clamp_min(qt[..., None] * xn2[rows, idx][None],
                                        1e-12)
        a0 = torch.gather(alpha, 2, idx.expand(R, SM, steps))
        dalpha, deltas = loop.run(xs, ys, yl, inv_qxx, a0,
                                  idx.expand(R, SM, steps), W, qt)
        u = ar.mm(deltas.unsqueeze(-2), xs).squeeze(-2)     # sum delta x
        alpha = alpha + dalpha
        v = v + u

        if omega_every and (h + 1) % omega_every == 0:
            W = 0.5 * ar.mm(K, by_cell(v))
            omega = _omega_step(ar, W)
            abar, K, q = _coupling(ar, omega, lam, sigma2)

    V = by_cell(v)
    W = 0.5 * ar.mm(K, V)
    yc, mc = by_cell(y.expand(R, SM, n)), by_cell(mask.expand(R, SM, n))
    conj = -(by_cell(alpha) * yc) * mc
    dual = conj.sum((-1, -2)) + 0.25 * torch.sum(
        K * ar.mm(V, V.transpose(-1, -2)), dim=(-1, -2))
    Xc = X.reshape(S, m, n, d).repeat(R, 1, 1, 1)
    z = ar.mm(Xc, W.unsqueeze(-1)).squeeze(-1)
    hinge = torch.clamp_min(1.0 - yc * z, 0.0) * mc
    primal = hinge.sum((-1, -2)) + torch.sum(
        abar * ar.mm(W, W.transpose(-1, -2)), dim=(-1, -2))

    def out(t):
        return t.reshape(R, S, *t.shape[1:]).double().cpu().numpy()

    return dict(W=out(W), omega=out(omega), primal=out(primal),
                dual=out(dual),
                budgets=np.broadcast_to(
                    budgets.reshape(S, 1, m).cpu().numpy(),
                    (S, rounds, m)).copy())


def heldout_wrong(W, test, tol: float = 1e-4):
    """Held-out predictions of the (R, S, m, d) weights ``W`` (numpy) on
    the stacked test split, in float64: the number of points each task
    gets wrong (sign(x . w) != y; a zero margin is wrong) and the number
    whose margin is within ``tol`` ||x|| ||w|| of zero, where float32
    rounding can flip the sign.  Both (R, S, m)."""
    X = test.X.double()
    Wt = torch.as_tensor(W, dtype=torch.float64, device=X.device)
    z = torch.einsum("smnd,rsmd->rsmn", X, Wt)
    real = test.mask[None] > 0
    wrong = (torch.sign(z) != torch.sign(test.y.double()[None])) & real
    scale = torch.linalg.norm(X, dim=-1)[None] * torch.linalg.norm(
        Wt, dim=-1)[..., None]
    near = (torch.abs(z) <= tol * scale) & real
    return (wrong.sum(-1).cpu().numpy(), near.sum(-1).cpu().numpy())
