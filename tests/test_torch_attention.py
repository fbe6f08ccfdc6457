"""The port's two attention kernel modules on the CPU: their plain versions
(which the wrappers run on CPU tensors) against the JAX package's oracles.

The JAX Pallas attention kernels no longer trace under the installed JAX
(``pl.load`` is gone), so the port is held against the kernels' references,
``repro.kernels.flash_attention.ref.attention_ref`` and
``repro.kernels.decode_attention.ref.decode_attention_ref``, fed the same
unit-normal inputs made with numpy.  Tolerances: f32 max abs 1e-5 (the two
take the same dense softmax, summed in another order); bf16 2e-2 (one bf16
rounding of outputs of size ~1).  The cases mirror ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import (decode_attention_ref as
                                                jax_decode_ref)
from repro.kernels.flash_attention.ref import attention_ref as jax_flash_ref
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)


def _flash_both(b, s, h, hkv, d, dtype="float32", **kw):
    q, k, v = _arrays((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    rep = h // hkv
    want = jax_flash_ref(qj.transpose(0, 2, 1, 3),
                         jnp.repeat(kj, rep, 2).transpose(0, 2, 1, 3),
                         jnp.repeat(vj, rep, 2).transpose(0, 2, 1, 3),
                         **kw).transpose(0, 2, 1, 3)
    FA.reset_counts()
    got = FA.flash_mha(qt, kt, vt, **kw)
    assert FA.COUNTS["flash_attention"] == 0   # the plain version on a CPU
    assert got.dtype == qt.dtype and got.shape == qt.shape
    return got, want


@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 32), (2, 3, 256, 64),
                                     (1, 2, 512, 128), (1, 1, 128, 256)])
def test_flash_plain_matches_jax_oracle_shapes(b, h, s, d):
    _assert_close(*_flash_both(b, s, h, h, d), "float32")


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_plain_sliding_window(window):
    _assert_close(*_flash_both(1, 256, 2, 2, 64, window=window), "float32")


def test_flash_plain_noncausal():
    _assert_close(*_flash_both(1, 128, 1, 1, 64, causal=False), "float32")


def test_flash_plain_bf16():
    _assert_close(*_flash_both(1, 128, 2, 2, 64, "bfloat16"), "bfloat16")


@pytest.mark.parametrize("h,hkv", [(4, 2), (15, 5), (8, 1)])
def test_flash_plain_gqa_wrapper(h, hkv):
    _assert_close(*_flash_both(1, 128, h, hkv, 64), "float32")


@pytest.mark.parametrize("s,window,causal", [(100, None, True),
                                             (77, 16, False),
                                             (1000, None, True)])
def test_flash_plain_ragged_sequence(s, window, causal):
    _assert_close(*_flash_both(1, s, 2, 1, 32, window=window, causal=causal),
                  "float32")


def _decode_both(b, h, hkv, t, d, lens, dtype="float32", garbage=None):
    q, k, v = _arrays((b, h, d), (b, t, hkv, d), (b, t, hkv, d), seed=1)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    lens = np.asarray(lens, np.int32)
    rep = h // hkv
    want = jax_decode_ref(qj, jnp.repeat(kj, rep, 2).transpose(0, 2, 1, 3),
                          jnp.repeat(vj, rep, 2).transpose(0, 2, 1, 3),
                          jnp.asarray(lens))
    DA.reset_counts()
    got = DA.decode_mha(qt[:, None], kt, vt, torch.from_numpy(lens))[:, 0]
    assert DA.COUNTS["decode_attention"] == 0
    assert got.dtype == qt.dtype and got.shape == qt.shape
    return got, want


@pytest.mark.parametrize("b,h,t,d", [(2, 2, 256, 64), (1, 4, 1024, 128),
                                     (3, 1, 512, 32), (1, 8, 2048, 64)])
def test_decode_plain_matches_jax_oracle(b, h, t, d):
    lens = np.random.default_rng(0).integers(1, t, (b,))
    _assert_close(*_decode_both(b, h, h, t, d, lens), "float32")


def test_decode_plain_bf16():
    _assert_close(*_decode_both(2, 2, 2, 256, 64, [200, 64], "bfloat16"),
                  "bfloat16")


@pytest.mark.parametrize("h,hkv,t", [(4, 2, 256), (15, 5, 1064)])
def test_decode_plain_gqa_wrapper(h, hkv, t):
    _assert_close(*_decode_both(2, h, hkv, t, 64, [t, t // 2]), "float32")


def test_decode_plain_lengths_one_and_full():
    _assert_close(*_decode_both(2, 4, 2, 100, 32, [1, 100]), "float32")


def test_decode_plain_length_masking_exact():
    """Slots past the valid length have exactly no influence."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        (1, 1, 1, 32), (1, 256, 1, 32), (1, 256, 1, 32), seed=2))
    lens = torch.tensor([100], dtype=torch.int32)
    out1 = DA.decode_mha(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:], v2[:, 100:] = 999.0, -999.0
    assert torch.equal(DA.decode_mha(q, k2, v2, lens), out1)


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.zeros((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        DA.decode_attention(q[:, 0], q, q, torch.ones(1, device="meta"))
