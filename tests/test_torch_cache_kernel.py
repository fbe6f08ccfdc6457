"""The cache attention kernel's two designs, from what the CPU can check:
which design a (dtype, head_dim) launches, the shared memory each built
instance asks for against the H100's 232,448 bytes a block, the tolerance
each design is held to on the card (``cache_tolerance``), and the rule
that cuts the cache's slots into chunks (``split_plan``).  The kernels
themselves run on the card only (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_attention as CA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.cache_attention.cache_attention import tiles
from repro_torch.kernels.flash_attention.ref import P_ROUNDING

F32, BF16 = torch.float32, torch.bfloat16
HEAD_DIMS = (32, 64, 112, 128, 256)
#: dynamic shared memory a block may ask for on an H100, and an SM's
#: (each block also takes 1 KB of the SM's 233,472 for the system)
BLOCK_SMEM, SM_SMEM = 232_448, 233_472


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_design_of_each_dtype_and_head_dim(d, dtype):
    """bf16 at head_dim 64, 112, 128, 256 on the tensor cores, everything
    else on the CUDA cores: the flash kernel's choice."""
    want = ("wgmma+tma" if dtype == BF16 and d in (64, 112, 128, 256)
            else "cuda-core")
    assert CA.design(dtype, d) == want == FA.design(dtype, d)
    tl = tiles(dtype, d)
    assert tl.rows == (128 if want == "wgmma+tma" else
                       {32: 128, 112: 32}.get(d, 64))
    assert tl.grouped == (want == "cuda-core")


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_shared_bytes_fit_the_card(d, dtype):
    """Every built instance fits one block's shared memory; the lean
    CUDA-core instances (f32 at head_dim 64 and 112) fit two blocks an
    SM, as their launch bounds ask."""
    nbytes = CA.shared_bytes(d, dtype)
    assert 0 < nbytes <= BLOCK_SMEM
    per_sm = tiles(dtype, d).blocks_per_sm
    assert per_sm * (nbytes + 1024) <= SM_SMEM
    assert per_sm == (2 if dtype == F32 and d in (64, 112) else 1)


def _case(b, s, t, h, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    k_pos = np.stack([rng.permutation(t) for _ in range(b)])
    k_pos[:, t - t // 8:] = -1
    q_pos = k_pos.max(1, keepdims=True) - s + 1 + np.arange(s)[None]
    q_pos[0] = np.arange(s) - s - 1           # row 0: no live slot
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]
    return ([torch.from_numpy(a).to(dtype) for a in arrays]
            + [torch.from_numpy(p.astype(np.int32)) for p in (q_pos, k_pos)])


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_cache_tolerance_adds_p_rounding_only_on_the_tensor_cores(
        d, dtype, window):
    """``cache_tolerance`` is ``attention_tolerance`` of the plain output,
    plus, where the wgmma design runs (it rounds P to bf16), exactly the
    flash kernel's ``P_ROUNDING`` x attn(|v|), attn(|v|) the plain version
    on |v| in f32."""
    q, k, v, qp, kp = _case(2, 5, 40, 4, 2, d, dtype)
    plain = CA.cache_attention_ref(q, k, v, qp, kp, window)
    tol = CA.cache_tolerance(q, k, v, qp, kp, plain, window)
    base = FA.attention_tolerance(plain)
    assert tol.dtype == torch.float32 and tol.shape == plain.shape
    if CA.design(dtype, d) == "cuda-core":
        assert torch.equal(tol, base)
        return
    abs_attn = CA.cache_attention_ref(q.float(), k.float(), v.float().abs(),
                                      qp, kp, window)
    assert torch.equal(tol, base + P_ROUNDING * abs_attn)
    assert bool((tol > base).all())
    # row 0 reads the mean of |v| over every slot
    torch.testing.assert_close(
        abs_attn[0], v[0].float().abs().mean(0).repeat_interleave(2, 0)
        .expand_as(abs_attn[0]))


def _waves_times_tiles(b, s, h, hkv, t, d, dtype, chunk, sms=132):
    tl = tiles(dtype, d)
    blocks = b * (hkv * -(-s * (h // hkv) // tl.rows) if tl.grouped
                  else h * -(-s // tl.rows))
    splits = -(-t // chunk)
    return (-(-blocks * splits // (tl.blocks_per_sm * sms))
            * (chunk // tl.keys))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [
    (8, 256, 15, 5, 1064, 64), (2, 64, 32, 32, 328, 112),
    (1, 256, 32, 8, 4096, 128), (1, 1, 8, 8, 33, 64),
    (2, 3, 4, 1, 500, 256), (4, 70, 6, 2, 333, 32), (1, 17, 2, 1, 9000, 64)])
def test_split_plan_takes_the_fewest_waves_of_tiles(shape, dtype):
    """The chunk is a whole number of the design's slot tiles, covers T in
    at most as many chunks as T has tiles, and no chunk of fewer splits
    (no split included) finishes in fewer waves x tiles; a grid of two
    waves or more is never split."""
    b, s, h, hkv, t, d = shape
    tl = tiles(dtype, d)
    chunk = CA.split_plan(b, s, h, hkv, t, d, dtype)
    n_tiles = -(-t // tl.keys)
    assert chunk % tl.keys == 0 and tl.keys <= chunk <= n_tiles * tl.keys
    cost = _waves_times_tiles(b, s, h, hkv, t, d, dtype, chunk)
    for per in range(chunk // tl.keys, n_tiles + 1):
        assert cost <= _waves_times_tiles(b, s, h, hkv, t, d, dtype,
                                          per * tl.keys)
    blocks = b * (hkv * -(-s * (h // hkv) // tl.rows) if tl.grouped
                  else h * -(-s // tl.rows))
    if blocks >= 2 * tl.blocks_per_sm * 132:
        assert chunk == n_tiles * tl.keys


def test_split_plan_depends_on_the_sm_count():
    """Fewer SMs, fewer splits: the rule fills the card it is given."""
    args = (2, 64, 32, 32, 328, 112, BF16)
    assert CA.split_plan(*args, sms=132) == 256
    assert CA.split_plan(*args, sms=32) == 384
