"""Tests of the port that need the card.  They skip where CUDA is absent.

This file imports nothing of JAX, so it also runs on a machine that has
PyTorch with CUDA and no JAX (``--noconftest`` skips ``tests/conftest.py``,
which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.subproblem import row_norms
from repro_torch.kernels import sdca as K


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


def _inputs(m, n, d, steps, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones((m, n), f)
    mask[:, n - 3:] = 0.0
    arrays = [rng.normal(size=(m, n, d)).astype(f),
              np.sign(rng.normal(size=(m, n))).astype(f), mask,
              np.zeros((m, n), f), (0.2 * rng.normal(size=(m, d))).astype(f),
              rng.uniform(0.5, 2.0, m).astype(f),
              rng.integers(0, steps, m).astype(np.int32),
              rng.integers(0, n - 3, (m, steps)).astype(np.int32)]
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,steps,gram", [
    (3, 16, 8, 32, None), (4, 32, 100, 64, None), (2, 48, 150, 64, None),
    (2, 40, 120, 96, True), (2, 300, 561, 300, None),
    (2, 300, 561, 300, True)])
def test_kernel_matches_plain_version(m, n, d, steps, gram):
    """Kernel against its plain version on the same inputs, the launch
    counted.  The reductions run in another order: atol 1e-5 on dalpha
    (bounded by 1) and u."""
    dev = _card()
    a = _inputs(m, n, d, steps, dev)
    xn = row_norms(a[0])
    K.reset_counts()
    da, u = K.sdca_local_solve(*a, steps, gram=gram, xnorm2=xn)
    torch.cuda.synchronize()
    assert K.COUNTS["sdca_local_solve"] == 1
    dr, ur = K.sdca_ref(*a, gram=gram, xnorm2=xn)
    torch.testing.assert_close(da, dr, atol=1e-5, rtol=0)
    torch.testing.assert_close(u, ur, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_budget_zero_and_mask_zero_are_exact_noops():
    dev = _card()
    a = _inputs(3, 64, 100, 64, dev, seed=1)
    for i, zero in ((6, torch.zeros_like(a[6])), (2, torch.zeros_like(a[2]))):
        b = list(a)
        b[i] = zero
        da, u = K.sdca_local_solve(*b, 64)
        assert not torch.any(da) and not torch.any(u)


@pytest.mark.cuda
def test_wrapper_checks_its_inputs():
    dev = _card()
    a = _inputs(2, 16, 8, 32, dev)
    bad = list(a)
    bad[0] = a[0].double()
    with pytest.raises(TypeError):
        K.sdca_local_solve(*bad, 32)
    bad = list(a)
    bad[4] = torch.empty((8, 2), device=dev).t()   # W (2, 8), strided
    with pytest.raises(ValueError, match="contiguous"):
        K.sdca_local_solve(*bad, 32)
    with pytest.raises(ValueError, match="shape"):
        K.sdca_local_solve(*a[:7], a[7][:, :5], 32)
