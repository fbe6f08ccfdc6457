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
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

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
                                     (1, 2, 512, 128), (1, 1, 128, 256),
                                     (2, 4, 256, 112)])      # zamba2-7b's
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
                                     (3, 1, 512, 32), (1, 8, 2048, 64),
                                     (2, 4, 280, 112)])
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


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 64, "cuda-core"), (torch.float32, 112, "cuda-core"),
    (torch.bfloat16, 32, "cuda-core"), (torch.bfloat16, 64, "wgmma+tma"),
    (torch.bfloat16, 112, "wgmma+tma"), (torch.bfloat16, 128, "wgmma+tma"),
    (torch.bfloat16, 256, "wgmma+tma")])
def test_flash_design_by_dtype_and_head_dim(dtype, d, want):
    """bf16 runs on the tensor cores at every head_dim but 32, 112
    included (its rows padded to two 64-column swizzle atoms in shared
    memory); f32 stays on the CUDA cores."""
    assert d in HEAD_DIMS
    assert FA.design(dtype, d) == want


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.zeros((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        DA.decode_attention(q[:, 0], q, q, torch.ones(1, device="meta"))


# ---------------------------------------------------------------------------
# the decode kernel's split and merge, in plain PyTorch
# ---------------------------------------------------------------------------

def _split_inputs(b, h, hkv, t, d, seed=3):
    q, k, v = _arrays((b, h, d), (b, t, hkv, d), (b, t, hkv, d), seed=seed)
    return q, k, v


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("lens", [
    [1, 64], [63, 65], [128, 129], [300, 300], [1, 2], [257, 190]])
def test_decode_split_ref_matches_jax_oracle(chunk, lens):
    """Lengths 1, on chunk boundaries (64, 128), T (300), and rows whose
    later chunks lie wholly past their length: the split-and-merge plain
    version against the JAX package's oracle and the port's plain version,
    within f32 rounding (max abs 1e-5 on outputs of size ~1)."""
    b, h, hkv, t, d = 2, 6, 2, 300, 32
    q, k, v = _split_inputs(b, h, hkv, t, d)
    lens_np = np.asarray(lens, np.int32)
    rep = h // hkv
    want = jax_decode_ref(jnp.asarray(q),
                          jnp.repeat(jnp.asarray(k), rep, 2).transpose(
                              0, 2, 1, 3),
                          jnp.repeat(jnp.asarray(v), rep, 2).transpose(
                              0, 2, 1, 3), jnp.asarray(lens_np))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    lt = torch.from_numpy(lens_np)
    got = DA.decode_attention_split_ref(qt, kt, vt, lt, chunk)
    assert torch.isfinite(got).all()
    _assert_close(got, want, "float32")
    torch.testing.assert_close(got, DA.decode_attention_ref(qt, kt, vt, lt),
                               atol=1e-6, rtol=0)


def test_decode_split_ref_dead_chunks_add_nothing():
    """Slots past a row's length add exactly nothing, whatever they hold
    (NaN included): chunks wholly past it merge as l = 0."""
    q, k, v = (torch.from_numpy(a) for a in _split_inputs(2, 4, 2, 256, 32))
    lens = torch.tensor([70, 1], dtype=torch.int32)
    out1 = DA.decode_attention_split_ref(q, k, v, lens, 64)
    k2, v2 = k.clone(), v.clone()
    k2[0, 70:], v2[0, 70:] = 999.0, float("nan")
    k2[1, 1:], v2[1, 1:] = float("inf"), float("nan")
    out2 = DA.decode_attention_split_ref(q, k2, v2, lens, 64)
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("t,b,hkv,chunk", [
    (1064, 8, 5, 128), (256, 1, 1, 64), (8192, 64, 8, 512), (130, 8, 2, 64),
    (1000, 6, 1, 64)])
def test_decode_split_plan(t, b, hkv, chunk):
    """The chunk is a multiple of 64, at most 512, and gives the split
    phase at least two blocks per SM of a 132-SM card where it can."""
    assert DA.split_plan(t, b, hkv, 132) == chunk
    n_split = -(-t // chunk)
    assert chunk % 64 == 0 and chunk <= 512
    assert b * hkv * n_split >= min(2 * 132, b * hkv * -(-t // 64))


# ---------------------------------------------------------------------------
# the bf16 flash rule: P rounded to bf16 passes, a misweighted tile fails
# ---------------------------------------------------------------------------

def _flash_emulation(q, k, v, causal=True, tile_scale=None):
    """The tensor-core kernel's arithmetic in plain PyTorch: f32 scores and
    probabilities, l summed from the f32 p, P rounded to bf16 before P V,
    the output rounded to bf16.  ``tile_scale`` (row, key0, key1, factor)
    misweights one key tile of one query row."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    sc = torch.einsum("bshd,bthd->bhst", q.float(), kf) / d ** 0.5
    pos = torch.arange(s)
    if causal:
        sc = sc.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l_sum = p.sum(-1, keepdim=True)
    pb = p.to(torch.bfloat16).float()
    if tile_scale is not None:
        row, k0, k1, f = tile_scale
        pb[:, :, row, k0:k1] *= f
    out = torch.einsum("bhst,bthd->bshd", pb, vf) / l_sum.transpose(1, 2)
    return out.to(torch.bfloat16)


def _share(out, q, k, v, causal=True):
    plain = FA.attention_ref(q, k, v, causal=causal)
    tol = FA.flash_tolerance(q, k, v, plain, causal=causal)
    return float(((out.float() - plain.float()).abs() / tol).max())


@pytest.mark.parametrize("s,h,hkv,d,causal", [
    (200, 2, 1, 64, True), (256, 4, 2, 128, True), (77, 2, 2, 64, False),
    (130, 2, 1, 256, True)])
def test_flash_bf16_rule_passes_rounded_probabilities(s, h, hkv, d, causal):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        (1, s, h, d), (1, s, hkv, d), (1, s, hkv, d), seed=5))
    assert _share(_flash_emulation(q, k, v, causal), q, k, v, causal) <= 1.0


def test_flash_bf16_rule_fails_a_misweighted_tile():
    """A row whose one key tile (rows 0..63 see keys of tile 0 only) is
    weighted 5% too much fails the rule; the same emulation without the
    misweighting passes it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        (1, 200, 2, 64), (1, 200, 1, 64), (1, 200, 1, 64), seed=5))
    assert _share(_flash_emulation(q, k, v), q, k, v) <= 1.0
    bad = _flash_emulation(q, k, v, tile_scale=(40, 0, 64, 1.05))
    assert _share(bad, q, k, v) > 1.5


# -- the decode kernel's log-sum-exp ------------------------------------------

def _decode_inputs(b, t, h, hkv, d, dtype, seed=0):
    q, k, v = _arrays((b, h, d), (b, t, hkv, d), (b, t, hkv, d), seed=seed)
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_lse_of_the_plain_versions(dtype):
    """``return_lse`` adds the log-sum-exp of each row's scaled scores over
    its live slots (numpy's), -inf for a row with none; both plain versions
    give it, and their outputs keep their bits."""
    q, k, v = _decode_inputs(4, 96, 4, 2, 32, dtype)
    lens = torch.tensor([0, 1, 50, 96])
    out, lse = DA.decode_attention_ref(q, k, v, lens, return_lse=True)
    assert torch.equal(out, DA.decode_attention_ref(q, k, v, lens))
    qf, kf = q.float().numpy(), k.float().numpy().repeat(2, axis=2)
    s = np.einsum("bhd,bthd->bht", qf, kf) / np.sqrt(32)
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.isneginf(lse[i]).all()
            continue
        top = s[i, :, :n].max(-1)
        want = top + np.log(np.exp(s[i, :, :n] - top[:, None]).sum(-1))
        np.testing.assert_allclose(lse[i].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    out2, lse2 = DA.decode_attention_split_ref(q, k, v, lens, 64,
                                               return_lse=True)
    assert torch.equal(out2, DA.decode_attention_split_ref(q, k, v, lens,
                                                           64))
    torch.testing.assert_close(lse2[1:], lse[1:], rtol=1e-6, atol=1e-5)
    assert torch.isneginf(lse2[0]).all() and not out2[0].any()


@pytest.mark.parametrize("lens", [[0, 3, 20, 40], [1, 19, 21, 40]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_merge_of_two_halves_is_one_call(dtype, lens):
    """A cache cut into two T-halves, each half read with ``return_lse``
    (lengths clamp(len - r T/2, 0, T/2)) and merged by ``merge_slices``,
    equals one call over the whole cache; a half with no live slot (every
    row of the first case's first two) adds exactly nothing."""
    b, t, h, hkv, d = 4, 40, 4, 1, 32
    q, k, v = _decode_inputs(b, t, h, hkv, d, dtype, seed=3)
    lens = torch.tensor(lens)
    half = t // 2
    outs, lses = [], []
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        o, l_ = DA.decode_mha(q[:, None], k[:, sl], v[:, sl],
                              (lens - r * half).clamp(0, half),
                              return_lse=True)
        outs.append(o)
        lses.append(l_)
    merged = DA.merge_slices(torch.stack(outs), torch.stack(lses))
    whole = DA.decode_mha(q[:, None], k, v, lens)
    live = lens > 0
    tol = {"float32": 1e-6, "bfloat16": 2e-2}[dtype]
    torch.testing.assert_close(merged[live].float(), whole[live].float(),
                               rtol=0, atol=tol)
    assert not merged[~live].any()
    w = DA.merge_weights(torch.stack(lses))
    assert (w[:, lens <= half][1] == 0).all()
