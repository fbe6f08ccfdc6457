"""Tests of the port that need the card.  They skip where CUDA is absent.

This file imports nothing of JAX, so it also runs on a machine that has
PyTorch with CUDA and no JAX (``--noconftest`` skips ``tests/conftest.py``,
which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.subproblem import row_norms
from repro_torch.kernels import cache_attention as CA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import sdca as K

#: the cache kernel's wrapper module (the package's ``cache_attention`` is
#: the function)
CK = importlib.import_module("repro_torch.kernels.cache_attention."
                             "cache_attention")


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
@pytest.mark.parametrize("name,pooled,mid_chunk", [
    ("vehicle_sensor", False, False), ("human_activity", False, False),
    ("vehicle_sensor", True, False), ("vehicle_sensor", True, True)],
    ids=["vehicle_sensor", "human_activity", "vehicle_sensor_global",
         "vehicle_sensor_global_mid_chunk"])
def test_sdca_kernel_at_federation_shapes(name, pooled, mid_chunk):
    """The MOCHA main path's shapes (Vehicle Sensor: gram, Human Activity:
    carry) and the "global" kind's (every Vehicle Sensor client's rows in
    one task, ~1,025 chunks in one block) with one-pass budgets, or 3/8 of
    a pass ending mid-chunk, and a feasible alpha, against the plain
    version within 2e-5 x max(1, max |plain|) (chip_smoke's KERNEL_TOL)."""
    from repro_torch.core.dual import with_xnorm2
    from repro_torch.data import synthetic
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    dev = _card()
    spec = getattr(synthetic, name.upper())
    data = synthetic.make_federation(spec, seed=0, device=dev)[0]
    if pooled:
        data = synthetic.make_global_problem(data)
    data = with_xnorm2(data)
    m, n, d = data.X.shape
    rng = np.random.default_rng(1)
    alpha = data.y * data.mask * torch.from_numpy(
        rng.uniform(0, 1, (m, n)).astype(np.float32)).to(dev)
    W = torch.from_numpy((0.1 * rng.normal(size=(m, d))).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.uniform(0.5, 2.0, m).astype(np.float32)).to(dev)
    budgets = torch.round(data.n_t).to(torch.int32)
    if mid_chunk:   # none a multiple of the chunk (32 in gram mode)
        budgets = (3 * budgets) // 8
        budgets = budgets + (budgets % 16 == 0).to(budgets.dtype)
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
    (1, 333, 6, 2, 32, True, 100, torch.bfloat16),
    # head_dim 112 (zamba2-7b): f32 on the CUDA cores (7 columns a lane in
    # two 16-byte chunks, the last one ragged; K's rows swizzled), bf16 on
    # the tensor cores (rows padded to 128 columns by TMA's zero fill); a
    # ragged S and, at H 1, a store past column 112 would land on the next
    # row
    (2, 333, 4, 4, 112, True, None, torch.float32),
    (1, 300, 6, 2, 112, True, 100, torch.float32),
    (1, 77, 2, 1, 112, False, 16, torch.float32),
    (2, 256, 32, 32, 112, True, None, torch.float32),
    (2, 333, 4, 4, 112, True, None, torch.bfloat16),
    (1, 300, 6, 2, 112, True, 100, torch.bfloat16),
    (2, 256, 32, 32, 112, True, None, torch.bfloat16),
    (1, 333, 4, 4, 112, False, 16, torch.bfloat16),
    (2, 300, 1, 1, 112, True, None, torch.bfloat16)])
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
@pytest.mark.parametrize("d", [64, 112, 128, 256])
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
                                          torch.bfloat16),
    (2, 280, 32, 32, 112, torch.float32), (2, 280, 32, 32, 112,
                                           torch.bfloat16),
    (3, 1000, 8, 2, 112, torch.float32), (3, 1000, 8, 2, 112,
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_decode_kernel_lse_matches_plain_version(d, dtype):
    """``return_lse``: each row's log-sum-exp against the plain split and
    merge's, within the output's f32 tolerance 2e-5 x max(1, |lse|), -inf
    exactly where a row has no live slot (length 0, output exactly 0); the
    output is the one without ``return_lse``, bit for bit."""
    dev = _card()
    b, t, h, hkv = 6, 600, 8, 2
    q = _normal((b, 1, h, d), dev, dtype, 0)
    k = _normal((b, t, hkv, d), dev, dtype, 1)
    v = _normal((b, t, hkv, d), dev, dtype, 2)
    lens = torch.tensor([0, 1, 63, 300, 599, 600], dtype=torch.int32,
                        device=dev)
    DA.reset_counts()
    out, lse = DA.decode_mha(q, k, v, lens, return_lse=True)
    plain = DA.decode_mha(q, k, v, lens)
    torch.cuda.synchronize()
    assert DA.COUNTS["decode_attention"] == 2
    assert torch.equal(out, plain)
    chunk = DA.split_plan(t, b, hkv, torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    _, want = DA.decode_attention_split_ref(q[:, 0], k, v, lens, chunk,
                                            return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    dead = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), dead) and dead[0].all()
    assert not dead[1:].any() and not out[0].any()
    err = (lse[~dead] - want[~dead]).abs()
    assert (err <= 2e-5 * want[~dead].abs().clamp_min(1.0)).all(), \
        float(err.max())


@pytest.mark.cuda
def test_decode_kernel_merges_over_two_halves_of_a_cache():
    """Two calls over the two T-halves of a cache, merged by their
    log-sum-exps (``merge_slices``), equal one call over the whole cache:
    the sequence-sharded decode of the mesh, on one card."""
    dev = _card()
    b, t, h, hkv, d = 4, 1040, 15, 5, 64
    q = _normal((b, 1, h, d), dev, seed=0)
    k = _normal((b, t, hkv, d), dev, seed=1)
    v = _normal((b, t, hkv, d), dev, seed=2)
    lens = torch.tensor([1, 520, 521, 1040], dtype=torch.int32, device=dev)
    half = t // 2
    parts = [DA.decode_mha(q, k[:, r * half:(r + 1) * half].contiguous(),
                           v[:, r * half:(r + 1) * half].contiguous(),
                           (lens - r * half).clamp(0, half),
                           return_lse=True) for r in range(2)]
    merged = DA.merge_slices(torch.stack([o for o, _ in parts]),
                             torch.stack([l for _, l in parts]))
    _close(merged[:, 0], DA.decode_mha(q, k, v, lens)[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernel_merges_over_two_halves_of_a_wrapped_ring(d, dtype):
    """A window's ring of 1024 slots, each row written position by position
    at slot pos % 1024 (rows of 5, 700, 1024 and 2600 positions: not
    full, full, wrapped twice), read over min(pos, 1024) slots: two calls
    over its two T-halves merged by their log-sum-exps equal one call over
    the whole ring (the mesh's sequence-sharded ring, on one card), and
    the plain version, within ``attention_tolerance`` plus the rounding of
    each half's output to the dtype before the merge (eps / 2 of the
    weighted halves' magnitudes: 2^-8 in bf16)."""
    dev = _card()
    b, t, h, hkv = 4, 1024, 8, 2
    written = [5, 700, 1024, 2600]
    q = _normal((b, 1, h, d), dev, dtype, 0)
    k = torch.zeros((b, t, hkv, d), device=dev, dtype=dtype)
    v = torch.zeros_like(k)
    for row, n in enumerate(written):
        kn = _normal((n, hkv, d), dev, dtype, 10 + row)
        vn = _normal((n, hkv, d), dev, dtype, 20 + row)
        for p in range(0, n, t):          # later laps overwrite the slots
            k[row, :min(t, n - p)] = kn[p:p + t]
            v[row, :min(t, n - p)] = vn[p:p + t]
    lens = torch.tensor([min(n, t) for n in written], dtype=torch.int32,
                        device=dev)
    half = t // 2
    DA.reset_counts()
    parts = [DA.decode_mha(q, k[:, r * half:(r + 1) * half].contiguous(),
                           v[:, r * half:(r + 1) * half].contiguous(),
                           (lens - r * half).clamp(0, half),
                           return_lse=True) for r in range(2)]
    whole = DA.decode_mha(q, k, v, lens)
    torch.cuda.synchronize()
    assert DA.COUNTS["decode_attention"] == 3
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    merged = DA.merge_slices(outs, lses)[:, 0]
    # each half's output is rounded to its dtype before the merge
    w = DA.merge_weights(lses)[:, :, None, :, None]
    halves = torch.finfo(dtype).eps / 2 * (w * outs.float().abs()).sum(0)
    halves = halves[:, 0]
    _close(merged, whole[:, 0], FA.attention_tolerance(whole[:, 0])
           + halves)
    plain = DA.decode_attention_ref(q[:, 0].cpu().float(),
                                    k.cpu().float(), v.cpu().float(),
                                    lens.cpu())
    _close(merged.cpu().float(), plain,
           FA.attention_tolerance(plain.to(dtype)) + halves.cpu())


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


# -- cache attention: a segment over the whole cache ----------------------

def _cache_case(b, s, t, h, hkv, d, dev, dtype, seed=0):
    """q at positions up to the cache's newest, the cache's slots a
    shuffle of positions with the last T / 16 unwritten (-1); row 0's
    queries before every position the cache holds (all masked)."""
    rng = np.random.default_rng(seed)
    k_pos = np.stack([rng.permutation(t) + r for r in range(b)])
    k_pos[:, t - t // 16:] = -1
    q_pos = k_pos.max(1, keepdims=True) - s + 1 + np.arange(s)[None]
    q_pos[0] = np.arange(s) - s - 1
    pos = [torch.from_numpy(a.astype(np.int32)).to(dev)
           for a in (q_pos, k_pos)]
    return (_normal((b, s, h, d), dev, dtype, seed),
            _normal((b, t, hkv, d), dev, dtype, seed + 1),
            _normal((b, t, hkv, d), dev, dtype, seed + 2), *pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("window", [None, 40])
def test_cache_kernel_matches_plain_version(d, dtype, window):
    """Every head_dim and dtype, with and without a window, GQA, a ragged
    S and T, a split over T (B 1, one kv head: few blocks) and not (B 4),
    row 0 all masked (the mean of V over every slot); within
    ``cache_tolerance`` (the bf16 tensor-core design's P rounding)."""
    dev = _card()
    for b, s, t, h, hkv in ((4, 70, 333, 6, 2), (2, 3, 500, 4, 1)):
        q, k, v, qp, kp = _cache_case(b, s, t, h, hkv, d, dev, dtype)
        CA.reset_counts()
        out = CA.cache_mha(q, k, v, qp, kp, window)
        torch.cuda.synchronize()
        assert CA.COUNTS["cache_attention"] == 1
        want = CA.cache_attention_ref(q, k, v, qp, kp, window)
        _close(out, want, CA.cache_tolerance(q, k, v, qp, kp, want, window))
        mean = v[0].float().mean(0).repeat_interleave(h // hkv, 0)
        _close(out[0], mean.expand(s, h, d).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 70, 333, 6, 2, 64),
                                   (2, 3, 500, 4, 1, 112)])
def test_cache_kernel_lse_matches_plain_version(shape, dtype):
    """``return_lse``: each row's log-sum-exp within 2e-5 x max(1, |lse|)
    of the plain version's, -inf exactly on the all-masked rows, the
    output bitwise the call's without it (split over T and not)."""
    dev = _card()
    q, k, v, qp, kp = _cache_case(*shape[:5], shape[5], dev, dtype)
    out, lse = CA.cache_attention(q, k, v, qp, kp, return_lse=True)
    plain = CA.cache_attention(q, k, v, qp, kp)
    _, want = CA.cache_attention_ref(q, k, v, qp, kp, return_lse=True)
    torch.cuda.synchronize()
    dead = torch.isneginf(want)
    assert dead[0].all() and not dead[1:].any()
    assert torch.equal(torch.isneginf(lse), dead)
    err = (lse[~dead] - want[~dead]).abs()
    assert bool((err <= 2e-5 * want[~dead].abs().clamp_min(1.0)).all())
    assert torch.equal(out, plain)


@pytest.mark.cuda
def test_cache_kernel_slices_merge_into_the_whole_cache():
    """The mesh's merge on one card: the cache in two halves, each read
    with ``return_lse`` and merged by ``merge_weights`` with the halves'
    slots, within the tolerance of one read of the whole cache, the
    all-masked row (the mean over both halves) included."""
    dev = _card()
    q, k, v, qp, kp = _cache_case(3, 40, 512, 8, 2, 64, dev, torch.float32)
    want = CA.cache_mha(q, k, v, qp, kp)
    halves = [CA.cache_mha(q, k[:, i:i + 256].contiguous(),
                           v[:, i:i + 256].contiguous(), qp,
                           kp[:, i:i + 256].contiguous(), return_lse=True)
              for i in (0, 256)]
    w = DA.merge_weights(torch.stack([lse for _, lse in halves]),
                         torch.tensor([256, 256]))
    got = sum(w[i][..., None] * halves[i][0] for i in range(2))
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.cuda
def test_a_planted_wrong_mask_fails_the_plain_version(tmp_path,
                                                      monkeypatch):
    """The kernel built from its source with the causal test ``kpos <=
    qpos`` (``live_slot``, which both designs call) planted as ``<`` (each
    query loses its own slot) must miss the plain version's tolerance in
    f32 (the CUDA-core design) and in bf16 (the tensor-core design): the
    comparison sees each design's mask.  Each query's own slot holds 4 x
    its q, so it carries most of the softmax and the plant moves the
    output by about |v|."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import build
    dev = _card()
    src = Path(build.SOURCES["cache_attention"]).read_text()
    assert src.count("kpos <= qpos") == 1
    planted = tmp_path / "cache_attention.cu"
    planted.write_text(src.replace("kpos <= qpos", "kpos < qpos"))
    lib = ctypes.CDLL(str(build.build([planted])[planted]))
    CK._bind(lib)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qp, kp = _cache_case(2, 40, 200, 4, 4, 64, dev, dtype)
        kp[:, :40] = qp               # each query's own position is cached
        k[:, :40] = 4.0 * q
        want = CA.cache_attention_ref(q, k, v, qp, kp)
        tol = CA.cache_tolerance(q, k, v, qp, kp, want)
        _close(CA.cache_attention(q, k, v, qp, kp), want, tol)
        cases.append((q, k, v, qp, kp, want, tol))
    monkeypatch.setattr(CK, "load", lambda name, bind: lib)
    for q, k, v, qp, kp, want, tol in cases:
        assert CA.design(q.dtype, 64) == ("cuda-core" if q.dtype ==
                                          torch.float32 else "wgmma+tma")
        got = CA.cache_attention(q, k, v, qp, kp)
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _close(got, want, tol)


def _positions(kind, b, s, t, dev):
    """q_pos (B, S) and k_pos (B, T) int32 of a real cache.  "monotone": a
    cache written from slot 0, slot t holding position t, its last T / 16
    slots not written (-1), the segment the newest S positions (its own
    slots written first, as ``Model.prefill`` does); "ring": a window's
    ring of T slots after 2.5 T positions, slot t holding the newest
    position = t mod T, the segment the newest S.  Row 0's queries lie
    before every position (all masked)."""
    if kind == "monotone":
        n = t - t // 16
        k_pos = np.where(np.arange(t) < n, np.arange(t), -1)
    else:
        n = 5 * t // 2
        k_pos = n - 1 - (n - 1 - np.arange(t)) % t
    k_pos = np.broadcast_to(k_pos, (b, t)).copy()
    q_pos = np.broadcast_to(n - s + np.arange(s), (b, s)).copy()
    q_pos[0] = np.arange(s) - s - 1
    return [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (q_pos, k_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_cache_kernel_designs_over_groups_splits_and_positions(
        d, dtype, g, monkeypatch):
    """Both designs (``CA.design``) at G = H / Hkv of 1 to 4, S 70 (no
    multiple of any query tile) over T 333 (no multiple of any slot tile),
    with and without a window; the slots as one chunk (no split), as one
    slot tile a chunk (the most splits) and as ``split_plan`` cuts them;
    positions as ``_cache_case`` shuffles them, a monotone cache and a
    wrapped ring.  Each within ``cache_tolerance``; row 0 (no live slot)
    the mean of V over every slot; one launch a call."""
    dev = _card()
    b, s, t, hkv = 2, 70, 333, 2
    h = g * hkv
    q, k, v, qp0, kp0 = _cache_case(b, s, t, h, hkv, d, dev, dtype)
    keys = CK.tiles(dtype, d).keys
    plan = CK.split_plan
    mean = v[0].float().mean(0).repeat_interleave(g, 0).expand(s, h, d)
    for chunking, chunk in (("whole", -(-t // keys) * keys), ("tile", keys),
                            ("plan", None)):
        monkeypatch.setattr(CK, "split_plan", plan if chunk is None else
                            lambda *a, chunk=chunk, **kw: chunk)
        for kind in ("shuffle", "monotone", "ring"):
            qp, kp = ((qp0, kp0) if kind == "shuffle"
                      else _positions(kind, b, s, t, dev))
            for window in (None, 40):
                CA.reset_counts()
                out = CA.cache_mha(q, k, v, qp, kp, window)
                torch.cuda.synchronize()
                assert CA.COUNTS["cache_attention"] == 1
                want = CA.cache_attention_ref(q, k, v, qp, kp, window)
                label = (chunking, kind, window)
                try:
                    _close(out, want, CA.cache_tolerance(q, k, v, qp, kp,
                                                         want, window))
                    _close(out[0], mean.to(dtype))
                except AssertionError as err:
                    raise AssertionError(f"{label}: {err}") from None


@pytest.mark.cuda
def test_cache_shared_bytes_match_the_source():
    """``shared_bytes`` (what the CPU tests hold under the card's 232,448
    bytes) is what the source's instances ask for."""
    from repro_torch.kernels import build
    _card()
    lib = build.load("cache_attention", CK._bind)
    for dtype, code in CK.DTYPES.items():
        for d in CK.HEAD_DIMS:
            assert lib.cache_attention_shared_bytes(d, code) == \
                CK.shared_bytes(d, dtype), (dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112])
def test_cache_kernel_halves_merge_in_both_designs(d, dtype):
    """The mesh's merge on one card, in both designs: the cache in two
    T-halves, each read with ``return_lse`` and merged by
    ``merge_weights`` with the halves' slots, against the plain version
    over the whole cache within ``cache_tolerance`` plus the rounding of
    each half's output to its dtype before the merge (eps / 2 of the
    weighted halves' magnitudes), the all-masked row (the mean over both
    halves) included."""
    dev = _card()
    q, k, v, qp, kp = _cache_case(3, 40, 512, 8, 2, d, dev, dtype)
    halves = [CA.cache_mha(q, k[:, i:i + 256].contiguous(),
                           v[:, i:i + 256].contiguous(), qp,
                           kp[:, i:i + 256].contiguous(), return_lse=True)
              for i in (0, 256)]
    outs = torch.stack([o for o, _ in halves]).float()
    w = DA.merge_weights(torch.stack([lse for _, lse in halves]),
                         torch.tensor([256, 256]))[..., None]
    got = (w * outs).sum(0).to(dtype)
    torch.cuda.synchronize()
    want = CA.cache_attention_ref(q, k, v, qp, kp)
    rounding = torch.finfo(dtype).eps / 2 * (w * outs.abs()).sum(0)
    _close(got, want, CA.cache_tolerance(q, k, v, qp, kp, want) + rounding)


@pytest.mark.cuda
def test_cache_wrapper_checks_its_inputs():
    dev = _card()
    q, k, v, qp, kp = _cache_case(1, 8, 64, 4, 2, 64, dev, torch.float32)
    with pytest.raises(TypeError):
        CA.cache_attention(q, k, v, qp, kp.long())
    with pytest.raises(ValueError, match="kv heads"):
        CA.cache_attention(_normal((1, 8, 3, 64), dev), k, v, qp, kp)
    with pytest.raises(ValueError, match="head_dim"):
        CA.cache_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous(), qp, kp)
    with pytest.raises(ValueError, match="contiguous"):
        CA.cache_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                           v, qp, kp)


# -- the other model families on the card ----------------------------------

def _card_and_cpu(cfg):
    """The same random weights on the card and on the CPU."""
    from repro_torch.models import build_model
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=_card(), seed=None)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


@pytest.mark.cuda
def test_ring_decode_matches_plain_version():
    """A reduced mixtral with window 8 decodes 24 tokens one at a time from
    an empty ring: each step writes slot pos % 8 and the decode kernel reads
    min(pos + 1, 8) slots; the CPU runs the plain versions on the same
    weights and tokens.  Logits within 1e-4 x max(1, max |logit|)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              sliding_window=8)
    card, cpu = _card_and_cpu(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    caches = [m.init_cache(2, 64, dtype=torch.float32) for m in (card, cpu)]
    assert caches[0]["blocks"][0]["k"].shape[1] == 8
    DA.reset_counts()
    for t in range(24):
        tok = torch.from_numpy(toks[:, t].astype(np.int32))
        got, caches[0] = card.decode_step(tok.to(card.device), caches[0],
                                          dtype=torch.float32)
        want, caches[1] = cpu.decode_step(tok, caches[1],
                                          dtype=torch.float32)
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * scale)
    torch.cuda.synchronize()
    assert DA.COUNTS["decode_attention"] == 24 * cfg.n_layers
    np.testing.assert_array_equal(caches[0]["blocks"][0]["pos"].cpu(),
                                  caches[1]["blocks"][0]["pos"])


@pytest.mark.cuda
def test_moe_on_the_card_matches_the_cpu_and_reruns_bitwise():
    """moe_apply with top-8 of 16 experts and drops: the card against the
    CPU within 1e-5 x max(1, max |y|), the aux terms within rtol 1e-5 and
    the drop share equal; two card runs equal bit for bit (the combine has
    no atomics).  Then a reduced MoE model generates on the card as on the
    CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.serve import Engine, ServeConfig
    dev = _card()
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              n_experts=16, top_k=8, capacity_factor=0.75)
    p = moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 64, cfg.d_model)).astype(np.float32))
    want, aux_cpu = moe_apply(p, x, cfg)
    pc = {k: v.to(dev) for k, v in p.items()}
    runs = [moe_apply(pc, x.to(dev), cfg) for _ in range(2)]
    assert float(aux_cpu["moe_drop_frac"]) > 0
    assert torch.equal(runs[0][0], runs[1][0])
    got, aux = runs[0]
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * scale)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[k]), float(aux_cpu[k]),
                                   rtol=1e-5)
    assert float(aux["moe_drop_frac"]) == float(aux_cpu["moe_drop_frac"])

    card, cpu = _card_and_cpu(get_config("granite-moe-1b-a400m").reduced())
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, card.cfg.vocab_size, (2, 24)))
    sc = ServeConfig(max_len=40, max_new_tokens=8)
    t_card, l_card = Engine(card, sc).generate({"tokens": tok.to(dev)},
                                               return_logits=True)
    t_cpu, l_cpu = Engine(cpu, sc).generate({"tokens": tok},
                                            return_logits=True)
    np.testing.assert_array_equal(t_card, t_cpu)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=0, atol=1e-4 * max(
        1.0, float(l_cpu.abs().max())))


# -- the pre-sampled driver, the sweep and the kernel grid on the card -------

def _mocha_exp(train, reg, *, engine="local", driver="auto", rounds=6,
               every=3):
    from repro_torch.api import Exec, Experiment, Method, Problem
    return Experiment(problem=Problem(train=train),
                      method=Method(regularizers=(reg,), rounds=rounds,
                                    omega_update_every=every),
                      exec=Exec(engine=engine, driver=driver))


def _spec(**kw):
    from repro_torch.data.synthetic import FederationSpec
    return FederationSpec(**dict(dict(name="card", m=5, d=40, n_min=80,
                                      n_max=150, clusters=2), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 200])
def test_graph_replay_matches_eager_rounds_bitwise(d):
    """The captured round, replayed, against the same round function run
    eagerly on the same inputs, round by round."""
    from repro_torch.core import HINGE, RoundProgram, with_xnorm2
    from repro_torch.core.engine import _scan_local_round
    from repro_torch.core.dual import DualState, init_state
    from repro_torch.data.synthetic import make_federation
    from repro_torch.utils import prng
    dev = _card()
    data = with_xnorm2(make_federation(_spec(d=d), seed=0, device=dev)[0])
    n_steps = data.n_max
    K = torch.eye(data.m, device=dev) * 0.3 + 0.05
    q_t = torch.full((data.m,), 0.4, device=dev)

    def step(st, x):
        return _scan_local_round(HINGE, n_steps, None, data, DualState(*st),
                                 x["K"], x["q_t"], x["budgets"], 1.0,
                                 x["key"])

    keys = prng.split(prng.PRNGKey(0, device=dev), 4)
    budgets = torch.round(data.n_t).to(torch.int32)
    rows = [budgets, budgets // 3, budgets // 2 + 1, budgets * 0]
    prog = RoundProgram(step, init_state(data),
                        dict(key=keys[0], budgets=rows[0], K=K, q_t=q_t))
    assert prog.graph is not None and prog.capture_s > 0
    eager = tuple(init_state(data))
    for h in range(4):
        prog.run(key=keys[h], budgets=rows[h])
        eager = step(eager, dict(key=keys[h], budgets=rows[h], K=K, q_t=q_t))
        torch.cuda.synchronize()
        for a, b in zip(prog.state, eager):
            assert torch.equal(a, b), h


@pytest.mark.cuda
def test_graph_reads_the_k_buffer_after_an_omega_step():
    """``set`` writes the new K into the captured buffer: the replay then
    agrees with an eager round on the new K and not with one on the old.
    A rebound K would leave the graph reading the old one."""
    from repro_torch.core import RoundProgram
    dev = _card()
    v = torch.randn(6, 8, device=dev)

    def step(st, x):
        return (x["K"] @ v + st[0],)

    K_old = torch.eye(6, device=dev)
    K_new = torch.randn(6, 6, device=dev)
    prog = RoundProgram(step, (torch.zeros(6, 8, device=dev),), dict(K=K_old))
    prog.run()
    after_old = prog.state[0].clone()
    prog.set(K=K_new)
    prog.run()
    torch.cuda.synchronize()
    torch.testing.assert_close(prog.state[0], K_new @ v + after_old)
    assert not torch.allclose(prog.state[0], K_old @ v + after_old)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 200])
def test_scanned_run_matches_loop_bitwise_on_the_card(d):
    from repro_torch.core import Clustered
    from repro_torch.data.synthetic import make_federation
    dev = _card()
    train = make_federation(_spec(d=d), seed=1, device=dev)[0]
    loop = _mocha_exp(train, Clustered(k=2), driver="loop").run(0)
    scan = _mocha_exp(train, Clustered(k=2), driver="scan").run(0)
    assert scan.provenance["driver"] == "scan"
    assert scan.result.capture_s > 0
    assert loop.history == scan.history
    for k in ("W", "omega", "round_budgets"):
        np.testing.assert_array_equal(getattr(loop.result, k),
                                      getattr(scan.result, k))


@pytest.mark.cuda
def test_sweep_cell_matches_its_single_run_on_the_card():
    """A cell of the batched sweep against the single run of that cell:
    objectives within rtol 1e-5 / atol 1e-4, W and Omega within rtol 1e-4
    / atol 1e-5 (batched products round in another order)."""
    from repro_torch.api import Exec, Experiment, Method, Problem
    from repro_torch.core import Probabilistic
    from repro_torch.data.synthetic import make_federation
    dev = _card()
    trains = [make_federation(_spec(), seed=s, device=dev)[0]
              for s in (0, 1)]
    regs = (Probabilistic(lam=0.01, sigma2=10.0),
            Probabilistic(lam=1.0, sigma2=10.0))
    rep = Experiment(problem=Problem(train=trains),
                     method=Method(regularizers=regs, rounds=6,
                                   omega_update_every=3)).run((0, 1))
    assert rep.provenance["path"] == "sweep"
    for r, s in ((0, 1), (1, 0)):
        one = _mocha_exp(trains[s], regs[r]).run(s)
        for k in ("dual", "primal", "gap"):
            np.testing.assert_allclose(getattr(rep.result, k)[r, s],
                                       one.final(k), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(rep.result.W[r, s], one.result.W,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(rep.result.omega[r, s], one.result.omega,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_grid_launches_once_per_round_per_cell():
    from repro_torch.api import Exec, Experiment, Method, Problem
    from repro_torch.core import Probabilistic
    from repro_torch.data.synthetic import make_federation
    dev = _card()
    trains = [make_federation(_spec(), seed=s, device=dev)[0]
              for s in (0, 1, 2)]
    regs = tuple(Probabilistic(lam=lam) for lam in (0.01, 1.0))
    K.reset_counts()
    rep = Experiment(problem=Problem(train=trains),
                     method=Method(regularizers=regs, rounds=4,
                                   omega_update_every=2),
                     exec=Exec(engine="kernel")).run(0)
    assert rep.provenance["path"] == "grid"
    assert K.COUNTS["sdca_local_solve"] == 4 * 2 * 3


# -- the cohort path on the card ----------------------------------------------

def _cohort_kernel_case(K_, dev, seed=0, drop=0.1):
    """The SDCA kernel's inputs at the cohort path's shape: K_ clients of
    CROSS_DEVICE_1K packed to n_pad 64 (d 32, gram mode; rows past each
    client's n_t have mask 0), a warm-start alpha, one-pass budgets with a
    share of the slots dropped to budget 0, streams from the port's PRNG."""
    from repro_torch.cohort import CROSS_DEVICE_1K, Population, pack_cohort
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    rng = np.random.default_rng(seed)
    ids = rng.choice(CROSS_DEVICE_1K.m, K_, replace=False)
    data = pack_cohort(Population(CROSS_DEVICE_1K), ids, device=dev)
    m, n, d = data.X.shape
    f = np.float32

    def on(a):
        return torch.from_numpy(a.astype(f)).to(dev)

    alpha = (data.y * data.mask * on(rng.uniform(0, 1, (m, n)))).contiguous()
    budgets = torch.round(data.n_t).to(torch.int32)
    budgets[torch.from_numpy(rng.random(m) < drop).to(dev)] = 0
    idx = draw_coordinates(prng.split(prng.PRNGKey(seed, device=dev), m),
                           data.n_t, n, n)
    return (data.X, data.y, data.mask, alpha, on(0.1 * rng.normal(
        size=(m, d))), on(rng.uniform(0.5, 2.0, m)), budgets, idx), data


@pytest.mark.cuda
def test_sdca_kernel_at_the_cohort_shape():
    """K 256 x n_pad 64 x d 32 (gram), dropped slots at budget 0 and padded
    rows at mask 0, against the plain version within 2e-5 x max(1,
    max|plain|); a dropped slot's output is exactly 0."""
    dev = _card()
    args, data = _cohort_kernel_case(256, dev)
    assert tuple(data.X.shape) == (256, 64, 32)
    K.reset_counts()
    da, u = K.sdca_local_solve(*args, 64, xnorm2=data.xnorm2)
    torch.cuda.synchronize()
    assert K.COUNTS["sdca_local_solve"] == 1
    dr, ur = K.sdca_ref(*args, xnorm2=data.xnorm2)
    scale = max(1.0, float(dr.abs().max()), float(ur.abs().max()))
    err = max(float((da - dr).abs().max()), float((u - ur).abs().max()))
    assert err <= 2e-5 * scale, (err, scale)
    dropped = args[6] == 0
    assert dropped.any()
    assert not torch.any(da[dropped]) and not torch.any(u[dropped])
    assert not torch.any(da * (1 - data.mask))


def _cohort_exp(engine="local", driver="auto", rounds=8, **ex):
    from repro_torch.api import Exec, Experiment, Method, Problem, Systems
    from repro_torch.cohort import Population, PopulationSpec
    from repro_torch.core import (BudgetConfig, Probabilistic,
                                  SystemsConfig)
    spec = PopulationSpec("card_pop", m=2000, d=32, n_min=16, n_max=64,
                          clusters=5)
    return Experiment(
        problem=Problem(population=Population(spec, seed=0)),
        method=Method(regularizers=(Probabilistic(lam=1e-2, sigma2=10.0),),
                      rounds=rounds, omega_update_every=4,
                      budget=BudgetConfig(passes=1.0)),
        systems=Systems(config=SystemsConfig(rate_lo=0.5, rate_hi=2.0),
                        sampler="weighted", dropout=0.1),
        exec=Exec(engine=engine, driver=driver, cohort=64, clusters=5, **ex))


def _same_cohort_bits(a, b):
    assert a.history == b.history
    for k in ("centroids", "omega_k", "assign", "participation"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.cuda
def test_cohort_local_engine_captures_once_and_replays_the_eager_bits():
    """Eight blocks on the pre-sampled driver capture one round program;
    every block replayed through it gives the loop driver's (eager) bits."""
    from repro_torch.core import RoundProgram
    _card()
    before = RoundProgram.captures
    scan = _cohort_exp().run(0)
    assert RoundProgram.captures - before == 1
    assert scan.provenance["driver"] == "scan"
    assert scan.result.captures == 1 and scan.result.capture_s > 0
    loop = _cohort_exp(driver="loop").run(0)
    assert loop.result.captures == 0
    _same_cohort_bits(scan.result, loop.result)


@pytest.mark.cuda
def test_cohort_overlap4_equals_overlap1_on_the_card():
    """The pipeline (pack and solve on their own threads, the capture
    beside the pack worker) at staleness 0 gives the sequential bits."""
    _card()
    seq = _cohort_exp().run(0)
    pipe = _cohort_exp(overlap=4).run(0)
    assert pipe.result.captures == 1
    _same_cohort_bits(seq.result, pipe.result)


@pytest.mark.cuda
def test_cohort_kernel_engine_launches_once_per_inner_round():
    """The kernel engine: one SDCA launch per inner round of every block;
    each block's objectives within 1e-4 of |primal| of the local engine's
    (chip_smoke's HISTORY_RTOL)."""
    _card()
    K.reset_counts()
    kern = _cohort_exp(engine="kernel", rounds=4, inner_rounds=2).run(0)
    assert K.COUNTS["sdca_local_solve"] == 4 * 2
    loc = _cohort_exp(rounds=4, inner_rounds=2).run(0)
    h, g = kern.history, loc.history
    scale = np.maximum(np.abs(np.asarray(g["primal"])), 1.0)
    for k in ("dual", "primal", "gap"):
        assert np.all(np.abs(np.asarray(h[k]) - np.asarray(g[k]))
                      <= 1e-4 * scale), k
    assert h["unique_clients"] == g["unique_clients"]


@pytest.mark.cuda
def test_cohort_resume_equals_the_uninterrupted_run_on_the_card(tmp_path):
    import dataclasses
    from repro_torch.cohort import BlockFailure, FaultConfig
    _card()
    ref = _cohort_exp(overlap=2).run(0)
    crash = _cohort_exp(overlap=2, checkpoint_every=2,
                        checkpoint_dir=str(tmp_path))
    crash = dataclasses.replace(crash, systems=dataclasses.replace(
        crash.systems, faults=FaultConfig(solve_fail_blocks=(5,))))
    with pytest.raises(BlockFailure):
        crash.run(0)
    res = _cohort_exp(overlap=2, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path), resume=True).run(0)
    assert res.result.resumed_from == 4    # the frontier at the crash
    _same_cohort_bits(ref.result, res.result)


def _serve_reads(sess, ids, X):
    """Reads on the caller's thread until training ends: (answers, each
    with the snapshot it was read under, or None when a swap raced it)."""
    reads = []
    while sess.training:
        snap = sess.store.current()
        z = sess.predict(ids, X)
        same = sess.predictor.snapshot_version == snap.version
        reads.append((z, snap if same else None))
    return reads


@pytest.mark.cuda
def test_device_lookup_equals_the_host_rule():
    """The Predictor's lookup on the card (gather, searchsorted over the
    cached ids, where) equals the host rule bit for bit; margins within f32
    rounding of the host dot product."""
    from repro_torch.serve import Predictor, ServedSnapshot, SnapshotStore
    dev = _card()
    res = _cohort_exp(rounds=4).run(0).result
    store = SnapshotStore()
    store.publish(ServedSnapshot.from_state(res.relationship))
    pred = Predictor(store)
    assert pred.device.type == "cuda"
    ids = np.random.default_rng(0).integers(0, res.relationship.m, 1024)
    host = store.current().client_weights(ids)
    np.testing.assert_array_equal(pred.lookup(ids), host)
    X = np.random.default_rng(1).normal(size=(1024, 32)).astype(np.float32)
    np.testing.assert_allclose(pred.predict(ids, X),
                               np.einsum("bd,bd->b", host, X), rtol=1e-5,
                               atol=1e-6)
    assert dev.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("engine,overlap", [("local", 1), ("local", 4),
                                            ("kernel", 2)])
def test_experiment_serve_on_the_card_equals_run(engine, overlap):
    """Serving on (a background training thread, reads on this thread
    throughout, the local engine's capture beside them) gives the bits of
    ``Experiment.run``; every answer equals the host rule on the snapshot
    it was read under."""
    from repro_torch.api import Serve
    from repro_torch.core import RoundProgram
    _card()
    exp = _cohort_exp(engine=engine, overlap=overlap)
    ref = exp.run(0)
    before = RoundProgram.captures
    K.reset_counts()
    sess = exp.serve(0, Serve(publish_every=1))
    ids = np.random.default_rng(2).integers(0, 2000, 256)
    X = np.random.default_rng(3).normal(size=(256, 32)).astype(np.float32)
    sess.start()
    reads = _serve_reads(sess, ids, X)
    res = sess.join(600)
    assert RoundProgram.captures - before == (engine == "local")
    assert K.COUNTS["sdca_local_solve"] == (8 if engine == "kernel" else 0)
    _same_cohort_bits(ref.result, res)
    print(f"serve {engine} overlap {overlap}: max_version_lag "
          f"{sess.predictor.max_version_lag}")
    assert sess.snapshot_version == 8 and sess.predictor.max_version_lag <= 1
    for z, snap in reads:
        if snap is not None:
            np.testing.assert_allclose(
                z, np.einsum("bd,bd->b", snap.client_weights(ids), X),
                rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,window", [(5, None), (1, 64)])
def test_flash_mha_gradients_on_the_card(dtype, hkv, window):
    """The differentiable flash_mha: the kernel's forward (one launch) within
    flash_tolerance of the plain version, and its backward (the plain
    recompute) equal to differentiating the plain version directly, for
    the same upstream gradient, in f32 and bf16 (bf16 accumulating in
    f32 inside the recompute): the same arithmetic, held to one unit in the
    last place of the leaf's scale (cuBLAS may pick another algorithm)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(2, 256, 15, 64), (2, 256, hkv, 64), (2, 256, hkv, 64)]
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in shapes)
    up = torch.randn(shapes[0], generator=g, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.reset_counts()
    out = FA.flash_mha(*leaves, causal=True, window=window)
    grads = torch.autograd.grad(out, leaves, up)
    torch.cuda.synchronize()
    assert FA.COUNTS["flash_attention"] == 1
    plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = FA.attention_ref(*plain_leaves, causal=True, window=window)
    want = torch.autograd.grad(plain, plain_leaves, up)
    tol = FA.flash_tolerance(q, k, v, plain.detach(), causal=True,
                             window=window)
    assert bool(((out.float() - plain.float()).abs() <= tol).all())
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    for a, b in zip(grads, want):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= ulp * scale


@contextlib.contextmanager
def _plain_attention():
    """The plain attention in place of the flash kernel in the model's
    layers (differentiated directly), for the route comparison only."""
    from repro_torch.models import layers
    saved = layers.flash_mha
    layers.flash_mha = FA.attention_ref
    try:
        yield
    finally:
        layers.flash_mha = saved


def _train_route(dtype, plain):
    """One train step of a reduced SmolLM (2 layers, d 128, 4 heads of 32)
    on the card, kernel or plain attention: (metrics, grads)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.models import build_model
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_grad_fn, make_train_step)
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, seed=0)
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    params, state = init_train_state(model, tc)
    batch = next(TokenStream(cfg, DataConfig(seq_len=128,
                                             batch_size=4)).batches(1))
    with _plain_attention() if plain else contextlib.nullcontext():
        grads, metrics = make_grad_fn(model, tc)(params, batch)
        make_train_step(model, tc)(params, state, batch)
    return metrics, grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_kernel_route_matches_plain_route(dtype):
    """One train step through the flash kernel (2 launches a forward and 2
    more in its backward, ``cfg.remat``'s recompute of each block: 8 with
    the gradient pass and the step) against the plain attention: ce
    and grad_norm within 1e-4 (f32) / 2e-2 (bf16) relative, every gradient
    within 1e-3 / 5e-2 of its leaf's largest |g| (the kernel's forward
    rounding carried through two layers' backward passes)."""
    from repro_torch.train.optimizer import tree_leaves
    _card()
    rel, grel = ((1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 5e-2))
    FA.reset_counts()
    km, kg = _train_route(dtype, plain=False)
    assert FA.COUNTS["flash_attention"] == 8
    pm, pg = _train_route(dtype, plain=True)
    for key in ("ce", "grad_norm"):
        assert abs(float(km[key]) - float(pm[key])) <= rel * abs(
            float(pm[key])), key
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= grel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b"])
def test_remat_recompute_on_the_device_thread(arch):
    """The gradients of a reduced step with ``cfg.remat`` against the step
    without, on the card, under a 2 x 2 stand-in ``activation_sharding``
    context (MoE in 4 routing groups).  The card runs the backward, and
    so each block's recompute, on autograd's device thread, where the
    context is set again by ``pjit_utils.checkpoint``: without it MoE's
    recompute routes in one group and the checkpoint's check raises.  f32:
    ce and loss within 1e-6 relative, every gradient within 1e-5 of its
    leaf's max |g| (the expert combine's backward accumulates through
    atomics on the card, so two runs need not be equal bit for bit)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_grad_fn)
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.utils.pjit_utils import activation_sharding
    dev = _card()
    cfg = get_config(arch).reduced()
    batch = next(TokenStream(cfg, DataConfig(seq_len=128,
                                             batch_size=4)).batches(1))
    tc = TrainConfig()
    runs = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device=dev, seed=0)
        params, _ = init_train_state(model, tc)
        with activation_sharding(make_test_mesh(2, 2), ("data", "model")):
            runs.append(make_grad_fn(model, tc)(params, batch))
    (g1, m1), (g0, m0) = runs
    for key in ("ce", "loss"):
        assert abs(float(m1[key]) - float(m0[key])) <= 1e-6 * abs(
            float(m0[key])), key
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale


def _sharded_run(dev, engine, d=40, **cfg_kw):
    from repro_torch.core import BudgetConfig, MeanRegularized, MochaConfig
    from repro_torch.core.mocha import _run_mocha
    from repro_torch.data.synthetic import make_federation
    train = make_federation(_spec(d=d), seed=2, device=dev)[0]
    cfg = MochaConfig(rounds=8, record_every=3, seed=3, device=str(dev),
                      budget=BudgetConfig(passes=1.0, systems_lo=0.5,
                                          drop_prob=0.3), **cfg_kw)
    return _run_mocha(train, MeanRegularized(0.5, 0.5), cfg, engine=engine)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 200])
def test_sharded_engine_on_one_nccl_rank_equals_local_bitwise(d):
    """The one-rank mesh on the card runs its gathers through NCCL and
    gives the local engine's bits (both on the loop driver)."""
    import torch.distributed as dist
    from repro_torch.core import ShardedEngine
    dev = _card()
    eng = ShardedEngine()
    got = _sharded_run(dev, eng, d=d, driver="loop")
    assert dist.get_backend_config(eng.mesh.get_group()).count("nccl") == 1
    assert eng.mesh.device_type == "cuda"
    want = _sharded_run(dev, "local", d=d, driver="loop")
    assert got.history == want.history
    for a, b in zip(got.state, want.state):
        assert a.device.type == "cuda" and torch.equal(a, b)
    np.testing.assert_array_equal(got.W, want.W)


@pytest.mark.cuda
def test_bf16_wire_on_the_card():
    """The bf16 wire on the card: v after one round is the bf16 image of
    the f32 wire's; a whole run holds the same run on the CPU within the
    run contract (objectives rtol 1e-5 / atol 1e-4)."""
    from repro_torch.core import HINGE, ShardedEngine, with_xnorm2
    from repro_torch.data.synthetic import make_federation
    from repro_torch.utils import prng
    dev = _card()
    data = with_xnorm2(make_federation(_spec(), seed=2, device=dev)[0])
    K = torch.eye(data.m, device=dev) * 0.3 + 0.05
    q_t = torch.full((data.m,), 0.4, device=dev)
    budgets = torch.round(data.n_t).to(torch.int32)
    vs = []
    for wire in (None, torch.bfloat16):
        eng = ShardedEngine(comm_dtype=wire)
        st = eng.setup(data, HINGE, data.n_max)
        vs.append(eng.round(st, K, q_t, budgets, 1.0,
                            prng.PRNGKey(0, device=dev)).v)
    assert torch.equal(vs[1], vs[0].to(torch.bfloat16).float())
    card = _sharded_run(dev, ShardedEngine(comm_dtype="bfloat16"))
    cpu = _sharded_run(torch.device("cpu"),
                       ShardedEngine(comm_dtype="bfloat16"))
    assert card.history["time"] == cpu.history["time"]
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(card.history[k], cpu.history[k],
                                   rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_the_ports_one_rank_group_ends_at_exit_on_the_card():
    """A one-rank ``engine="sharded"`` run on the card (its group carries
    NCCL) exits 0 with the group ended: no group at exit, and no warning
    that ``destroy_process_group()`` was not called."""
    from test_torch_examples import run_group_exit
    _card()
    out = run_group_exit("cuda", "keep", card=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "initialized at exit: False"
    assert "destroy_process_group() was not called" not in out.stderr
    assert "Traceback" not in out.stderr
