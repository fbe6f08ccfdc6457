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
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
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
    (2, 300, 561, 300, True), (4, 64, 100, 64, False),
    (3, 20, 8, 5, None), (2, 20, 700, 9, None)])
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
@pytest.mark.parametrize("m,n,d,steps,gram,budgets,dup", [
    # budgets that end inside a chunk (C 32 gram, 16 and 64 carry)
    (3, 100, 100, 100, None, [45, 77, 1], None),
    (3, 90, 180, 90, None, [17, 40, 89], None),
    (2, 300, 561, 300, None, [65, 130], None),
    # n not a multiple of C; d 561 is not a multiple of 4
    (2, 301, 561, 301, True, [301, 150], None),
    (3, 77, 100, 77, False, [77, 50, 20], None),
    # duplicate-heavy streams: a coordinate repeated inside one chunk and
    # across chunks, in both modes and with a forced mode each way
    (3, 100, 100, 100, None, None, 3),
    (2, 300, 561, 300, None, None, 5),
    (2, 300, 561, 300, True, None, 2),
    (3, 100, 100, 100, False, None, 7),
    # d = 3 (mod 4): rows of one chunk start at all four shifts, so a slot
    # holds rows of different lengths from chunk to chunk (carry at C 64,
    # and forced carry at C 16)
    (2, 300, 563, 300, None, None, None),
    (3, 200, 99, 200, False, [200, 131, 77], None),
    # r wider than the registers (d > 864), and a chunk's rows beyond the
    # shared memory (d 800 at n 1200): carry with r in shared memory
    (2, 300, 1000, 300, None, [300, 170], None),
    (2, 300, 1000, 300, None, None, 5),
    (1, 1200, 800, 300, None, None, None)])
def test_sdca_kernel_budgets_widths_and_duplicates(m, n, d, steps, gram,
                                                    budgets, dup):
    """Kernel against its plain version where the redesign's bookkeeping
    matters: a budget that ends mid-chunk, ragged n and d, and streams that
    repeat a coordinate (the running dalpha each step reads)."""
    dev = _card()
    a = _inputs(m, n, d, steps, dev, seed=4)
    if budgets is not None:
        a[6] = torch.tensor(budgets, dtype=torch.int32, device=dev)
    else:
        a[6] = torch.full((m,), steps, dtype=torch.int32, device=dev)
    if dup is not None:
        a[7] = a[7] % dup
    xn = row_norms(a[0])
    da, u = K.sdca_local_solve(*a, steps, gram=gram, xnorm2=xn)
    torch.cuda.synchronize()
    dr, ur = K.sdca_ref(*a, gram=gram, xnorm2=xn)
    torch.testing.assert_close(da, dr, atol=1e-5, rtol=0)
    torch.testing.assert_close(u, ur, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vehicle_sensor", "human_activity"])
def test_sdca_kernel_at_federation_shapes(name):
    """The MOCHA main path's shapes (Vehicle Sensor: gram, Human Activity:
    carry) with one-pass budgets and a feasible alpha, against the plain
    version within 2e-5 x max(1, max |plain|) (chip_smoke's KERNEL_TOL)."""
    from repro_torch.core.dual import with_xnorm2
    from repro_torch.data import synthetic
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    dev = _card()
    spec = getattr(synthetic, name.upper())
    data = with_xnorm2(synthetic.make_federation(spec, seed=0,
                                                 device=dev)[0])
    m, n, d = data.X.shape
    rng = np.random.default_rng(1)
    alpha = data.y * data.mask * torch.from_numpy(
        rng.uniform(0, 1, (m, n)).astype(np.float32)).to(dev)
    W = torch.from_numpy((0.1 * rng.normal(size=(m, d))).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.uniform(0.5, 2.0, m).astype(np.float32)).to(dev)
    budgets = torch.round(data.n_t).to(torch.int32)
    idx = draw_coordinates(prng.split(prng.PRNGKey(1, device=dev), m),
                           data.n_t, n, n)
    args = (data.X, data.y, data.mask, alpha.contiguous(), W, q, budgets, idx)
    da, u = K.sdca_local_solve(*args, n, xnorm2=data.xnorm2)
    dr, ur = K.sdca_ref(*args, xnorm2=data.xnorm2)
    torch.cuda.synchronize()
    scale = max(1.0, float(dr.abs().max()), float(ur.abs().max()))
    err = max(float((da - dr).abs().max()), float((u - ur).abs().max()))
    assert err <= 2e-5 * scale, (err, scale)


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
@pytest.mark.parametrize("d,gram", [(100, None), (563, None), (1000, None),
                                    (100, False)])
def test_sdca_kernel_takes_an_unaligned_x(d, gram):
    """X a contiguous view one float into its storage: no row starts on a
    16-byte boundary the kernel could assume."""
    dev = _card()
    m, n, steps = 2, 120, 120
    a = _inputs(m, n, d, steps, dev, seed=6)
    storage = torch.empty(m * n * d + 1, device=dev)
    a[0] = storage[1:].view(m, n, d).copy_(a[0])
    assert a[0].data_ptr() % 16
    xn = row_norms(a[0])
    da, u = K.sdca_local_solve(*a, steps, gram=gram, xnorm2=xn)
    torch.cuda.synchronize()
    dr, ur = K.sdca_ref(*a, gram=gram, xnorm2=xn)
    torch.testing.assert_close(da, dr, atol=1e-5, rtol=0)
    torch.testing.assert_close(u, ur, atol=1e-5, rtol=0)


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


# ---------------------------------------------------------------------------
# flash and decode attention: kernel against its plain version on the card
# ---------------------------------------------------------------------------

#: kernel vs plain version, element by element, by the rule of
#: ``kernels/flash_attention/ref.py`` (``attention_tolerance``): f32 within
#: 2e-5 x max(1, max |want|) (sums in another order); bf16 also 1e-2 x |want|
#: (one rounding of each output), and for the bf16 flash kernel 2^-7 x
#: attn(|v|) (P rounded to bf16 before P V, ``flash_tolerance``)


def _normal(shape, dev, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dtype)


def _close(got, want, tol=None):
    assert got.dtype == want.dtype
    if tol is None:
        tol = FA.attention_tolerance(want)
    share = float(((got.float() - want.float()).abs() / tol).max())
    assert share <= 1.0, share


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,dtype", [
    (1, 128, 1, 1, 32, True, None, torch.float32),
    (2, 256, 3, 3, 64, True, None, torch.float32),
    (1, 512, 2, 2, 128, True, None, torch.float32),
    (1, 128, 1, 1, 256, True, None, torch.float32),
    (1, 256, 2, 2, 64, True, 32, torch.float32),
    (1, 256, 2, 2, 64, True, 64, torch.float32),
    (1, 256, 2, 2, 64, True, 128, torch.float32),
    (1, 128, 1, 1, 64, False, None, torch.float32),
    (1, 128, 2, 2, 64, True, None, torch.bfloat16),
    (1, 128, 4, 2, 64, True, None, torch.float32),
    (2, 100, 15, 5, 64, True, None, torch.float32),
    (1, 1000, 6, 2, 128, True, None, torch.bfloat16),
    (1, 77, 2, 1, 64, False, 16, torch.float32),
    # the bf16 tensor-core kernel: head_dim 64 / 128 / 256, S a multiple of
    # the tile and ragged, windows, non-causal, GQA 15/5
    (2, 256, 2, 2, 64, True, None, torch.bfloat16),
    (1, 512, 3, 3, 128, True, None, torch.bfloat16),
    (1, 256, 2, 1, 256, True, None, torch.bfloat16),
    (1, 77, 2, 1, 64, True, None, torch.bfloat16),
    (1, 77, 2, 2, 128, False, None, torch.bfloat16),
    (1, 1000, 2, 1, 256, True, None, torch.bfloat16),
    (1, 1000, 15, 5, 64, True, None, torch.bfloat16),
    (1, 384, 2, 2, 64, True, 100, torch.bfloat16),
    (1, 384, 2, 2, 128, True, 200, torch.bfloat16),
    (1, 384, 2, 1, 256, False, 64, torch.bfloat16),
    (1, 256, 2, 2, 64, False, None, torch.bfloat16),
    (2, 1024, 15, 5, 64, True, None, torch.bfloat16),
    (1, 128, 2, 2, 32, True, None, torch.bfloat16),
    # the f32 CUDA-core kernel: S not a multiple of its 128- or 64-row query
    # tiles and 64- or 32-key tiles, windows, GQA, every head_dim
    (2, 333, 6, 2, 32, True, 100, torch.float32),
    (2, 333, 6, 2, 64, True, 100, torch.float32),
    (1, 333, 6, 3, 128, True, 70, torch.float32),
    (1, 333, 4, 2, 256, True, 50, torch.float32),
    (1, 200, 4, 1, 64, False, 64, torch.float32),
    (1, 1000, 15, 5, 64, True, None, torch.float32),
    (1, 257, 4, 2, 128, False, None, torch.float32),
    (1, 257, 2, 1, 256, True, None, torch.float32),
    (1, 333, 6, 2, 32, True, 100, torch.bfloat16)])
def test_flash_kernel_matches_plain_version(b, s, h, hkv, d, causal, window,
                                            dtype):
    dev = _card()
    q = _normal((b, s, h, d), dev, dtype, 0)
    k = _normal((b, s, hkv, d), dev, dtype, 1)
    v = _normal((b, s, hkv, d), dev, dtype, 2)
    FA.reset_counts()
    out = FA.flash_mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.COUNTS["flash_attention"] == 1
    want = FA.attention_ref(q, k, v, causal=causal, window=window)
    _close(out, want, FA.flash_tolerance(q, k, v, want, causal=causal,
                                         window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bf16_one_hot_probabilities(d):
    """Each query row's score for one key (a permutation of the rows) is far
    above the rest, so P is one-hot and the output is that key's v row: a
    probability that reaches the wrong key (a wrong register layout of the
    P V operand) shows as an error of order |v|."""
    dev = _card()
    b, s, h, hkv = 2, 192, 4, 2
    k = _normal((b, s, hkv, d), dev, seed=1)
    v = _normal((b, s, hkv, d), dev, seed=2)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(s)).to(dev)
    rep = h // hkv
    q = 8.0 * k[:, perm].repeat_interleave(rep, dim=2)
    q, k, v = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
    out = FA.flash_mha(q, k, v, causal=False)
    want = v[:, perm].repeat_interleave(rep, dim=2)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=1e-2)
    _close(out, FA.attention_ref(q, k, v, causal=False),
           FA.flash_tolerance(q, k, v, FA.attention_ref(q, k, v,
                                                        causal=False),
                              causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hkv,d,dtype", [
    (2, 256, 2, 2, 64, torch.float32), (1, 1024, 4, 4, 128, torch.float32),
    (3, 512, 1, 1, 32, torch.float32), (1, 2048, 8, 8, 64, torch.float32),
    (2, 256, 2, 2, 64, torch.bfloat16), (2, 256, 4, 2, 64, torch.float32),
    (8, 1064, 15, 5, 64, torch.float32), (8, 1064, 15, 5, 64,
                                          torch.bfloat16)])
def test_decode_kernel_matches_plain_version(b, t, h, hkv, d, dtype):
    dev = _card()
    q = _normal((b, 1, h, d), dev, dtype, 0)
    k = _normal((b, t, hkv, d), dev, dtype, 1)
    v = _normal((b, t, hkv, d), dev, dtype, 2)
    rng = np.random.default_rng(3)
    lens = rng.integers(1, t, b)
    lens[0], lens[-1] = 1, t          # both ends of the range
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    DA.reset_counts()
    out = DA.decode_mha(q, k, v, lens)
    torch.cuda.synchronize()
    assert DA.COUNTS["decode_attention"] == 1
    _close(out[:, 0], DA.decode_attention_ref(q[:, 0], k, v, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d", [
    (8, 1064, 15, 5, 64), (8, 300, 4, 2, 128), (6, 1000, 8, 1, 256),
    (8, 130, 2, 2, 32)])
def test_decode_kernel_at_split_boundaries(b, t, h, hkv, d, dtype):
    """Lengths 1, 63, 64, 65, 128, T and ones that end inside a chunk, with
    T not a multiple of the chunk (``split_plan``), in f32 and bf16."""
    dev = _card()
    chunk = DA.split_plan(t, b, hkv,
                          torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    assert t % chunk, (t, chunk)       # the last chunk is ragged
    q = _normal((b, 1, h, d), dev, dtype, 0)
    k = _normal((b, t, hkv, d), dev, dtype, 1)
    v = _normal((b, t, hkv, d), dev, dtype, 2)
    want_lens = [1, 63, 64, 65, 128, t, chunk + 1, t - 1]
    lens = torch.tensor([min(x, t) for x in want_lens][:b], dtype=torch.int32,
                        device=dev)
    out = DA.decode_mha(q, k, v, lens)
    torch.cuda.synchronize()
    want = DA.decode_attention_ref(q[:, 0], k, v, lens)
    _close(out[:, 0], want)
    _close(out[:, 0], DA.decode_attention_split_ref(q[:, 0], k, v, lens,
                                                    chunk))


@pytest.mark.cuda
def test_decode_kernel_ignores_slots_past_lengths_bitwise():
    dev = _card()
    q = _normal((2, 1, 4, 32), dev, seed=0)
    k = _normal((2, 256, 2, 32), dev, seed=1)
    v = _normal((2, 256, 2, 32), dev, seed=2)
    lens = torch.tensor([100, 1], dtype=torch.int32, device=dev)
    out1 = DA.decode_mha(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 100:], v2[0, 100:] = 999.0, float("nan")
    k2[1, 1:], v2[1, 1:] = float("inf"), -999.0
    out2 = DA.decode_mha(q, k2, v2, lens)
    assert torch.equal(out1, out2)


@pytest.mark.cuda
def test_attention_wrappers_check_their_inputs():
    dev = _card()
    q = _normal((1, 64, 2, 48), dev)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
    q = _normal((1, 64, 3, 64), dev)
    with pytest.raises(ValueError, match="kv heads"):
        FA.flash_attention(q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous())
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.double(), q)
    cache = torch.zeros((1, 3, 64, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        DA.decode_attention(q[:, 0], cache, cache,
                            torch.ones(1, dtype=torch.int32, device=dev))
