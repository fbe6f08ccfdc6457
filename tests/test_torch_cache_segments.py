"""A segment that continues a KV cache, in the port against the JAX
package on the CPU: the three cached cases that the port used to refuse.

(a) A segment into a non-empty cache without a window (the JAX package's
    ``dynamic_update_slice``, whose start is clamped to T - S when the
    segment would overflow the cache).
(b) A segment into a window's ring at cache_pos > 0 (slots (cache_pos + i)
    % T, written before they are read: with T == window a query loses the
    in-window keys that later tokens of its own segment overwrote, the JAX
    package's result, which the port keeps; one test shows it differs from
    the windowed full-sequence forward).
(c) A prompt longer than the ring (the later token wins a slot, as the
    JAX package's scatter on the CPU; a query whose every key was
    overwritten reads the mean of V over the ring's slots, the JAX
    package's finite mask).

``attention_apply`` (out, k, v and pos), ``Model.prefill`` twice then
decode for a dense, MoE, vlm, audio and hybrid config, the same segments
on a 2 x 2 mesh of four gloo ranks against one device, and the kernel's
plain version against the decode kernel's at S 1.  Attention runs the
kernels' plain versions on the CPU (the wrapper decides by the tensor's
device), so no kernel launch is counted.

Tolerance: 1e-4 x max(1, max |value|) in f32 (float32 matmuls and
softmaxes summed in another order), as ``test_torch_lm.py``; cache
positions bit for bit; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels.decode_attention.ref import (decode_attention_ref as
                                                jax_decode_ref)
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import cache_attention as CA
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  merge_weights)
from repro_torch.models import layers as L

from test_torch_mesh_step import _spawn

RTOL = 1e-4
B = 2


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cfgs(arch="smollm-360m", **kw):
    if arch == "smollm-360m":
        kw = dict(dict(n_heads=4, n_kv_heads=2), **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _attn_params(jcfg):
    p = jax.tree_util.tree_map(
        np.asarray, JL.attention_init(jax.random.PRNGKey(2), jcfg))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            {k: torch.tensor(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# attention_apply
# ---------------------------------------------------------------------------

#: (window, max_len, spans): each span (first token, end) a call of
#: attention_apply at cache_pos = first token for every row, or per row
#: where a span is a list of (first, end) per row
CASES = {
    # (a) a segment into a non-empty cache, per-row offsets too
    "a_continue": (None, 16, [(0, 5), (5, 9), (9, 12)]),
    "a_rows_apart": (None, 16, [(0, 5), [(5, 9), (2, 6)]]),
    # (a) overflowing: start clamped from 12 to 16 - 6 = 10
    "a_overflow": (None, 16, [(0, 12), (12, 18)]),
    # (b) into the ring at cache_pos > 0: T == window, and T < window
    "b_wrapped": (4, 16, [(0, 4), (4, 7), (7, 10)]),
    "b_partial_ring": (6, 16, [(0, 5), (5, 9)]),
    "b_max_len_under_window": (8, 6, [(0, 2), (2, 5)]),
    # (c) longer than the ring: fresh, and continuing (all-masked rows)
    "c_fresh": (4, 16, [(0, 10)]),
    "c_continue": (4, 16, [(0, 3), (3, 12)]),
}


def _spans(span):
    return span if isinstance(span, list) else [span] * B


def _run_case(window, max_len, spans, seed=3):
    """Every span through both packages: (outputs JAX, port, caches)."""
    jcfg, cfg = _cfgs()
    pj, pt = _attn_params(jcfg)
    n = max(e for sp in spans for _, e in _spans(sp))
    x = 0.5 * _rand(B, n, cfg.d_model, seed=seed)
    cj = JL.init_attn_cache(jcfg, B, max_len, window=window,
                            dtype=jnp.float32)
    ct = L.init_attn_cache(cfg, B, max_len, window=window,
                           dtype=torch.float32)
    outs = []
    for sp in spans:
        rows = _spans(sp)
        s = rows[0][1] - rows[0][0]
        assert all(e - a == s for a, e in rows)
        xs = np.stack([x[i, a:e] for i, (a, e) in enumerate(rows)])
        pos = np.stack([np.arange(a, e, dtype=np.int32) for a, e in rows])
        cp = np.array([a for a, _ in rows], np.int32)
        want, cj = JL.attention_apply(pj, jnp.asarray(xs), jcfg,
                                      jnp.asarray(pos), window=window,
                                      cache=cj, cache_pos=jnp.asarray(cp))
        got, ct = L.attention_apply(pt, torch.from_numpy(xs), cfg,
                                    torch.from_numpy(pos), window=window,
                                    cache=ct, cache_pos=torch.from_numpy(cp))
        outs.append((want, got))
    return outs, cj, ct


@pytest.mark.parametrize("case", list(CASES))
def test_attention_apply_segment_matches_jax(case):
    CA.reset_counts()
    outs, cj, ct = _run_case(*CASES[case])
    for want, got in outs:
        _close(got, want)
    for name in ("k", "v"):
        _close(ct[name], cj[name])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert CA.COUNTS["cache_attention"] == 0      # the plain version


def test_overflowing_segment_lands_where_jax_clamps_it():
    _, cj, ct = _run_case(*CASES["a_overflow"])
    want = np.concatenate([np.arange(10), np.arange(12, 18)])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.stack([want] * B))


def test_longer_than_the_ring_keeps_the_later_tokens():
    """(c): positions 6..9 of a 10-token prompt in a 4-slot ring, slot p %
    4; the queries at 0..5 see none of their keys, so each reads the mean
    of V over the 4 slots (JAX's finite mask)."""
    _, cj, ct = _run_case(*CASES["c_fresh"])
    np.testing.assert_array_equal(ct["pos"].numpy(),
                                  np.stack([[8, 9, 6, 7]] * B))
    q_pos = torch.arange(10, dtype=torch.int32)[None].expand(B, -1)
    dead = ~CA.cache_mask(q_pos, ct["pos"], 4).any(-1)
    assert dead[:, :6].all() and not dead[:, 6:].any()


def test_jax_segment_into_a_wrapped_ring_differs_from_the_forward():
    """(b) is the JAX package's fault, which the port keeps: with T ==
    window the segment overwrites slots before its own earlier queries
    read them, so the ring's result is not the windowed forward's."""
    window, max_len, spans = CASES["b_wrapped"]
    jcfg, _ = _cfgs()
    pj, _ = _attn_params(jcfg)
    outs, _, _ = _run_case(window, max_len, spans)
    x = 0.5 * _rand(B, 10, jcfg.d_model, seed=3)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (B, 10))
    full, _ = JL.attention_apply(pj, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 window=window)
    full = np.asarray(full)
    want, got = outs[1]                       # tokens 4..6 at cache_pos 4
    _close(got, want)
    gap = np.abs(np.asarray(want) - full[:, 4:7]).max(axis=(0, 2))
    # query i of the segment loses the 3 - i - 1 in-window keys that the
    # later tokens overwrote: 4 loses keys 1 and 2, 5 loses 2, 6 none
    assert gap[0] > 1e-3 and gap[1] > 1e-3 and gap[2] < 1e-5


def test_segment_longer_than_a_cache_without_a_window_raises():
    """The JAX package fails to trace there (dynamic_update_slice's update
    larger than its operand); the port raises ValueError."""
    jcfg, cfg = _cfgs()
    pj, pt = _attn_params(jcfg)
    x = np.zeros((1, 6, cfg.d_model), np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    with pytest.raises(Exception):
        JL.attention_apply(pj, jnp.asarray(x), jcfg, jnp.asarray(pos),
                           cache=JL.init_attn_cache(jcfg, 1, 4,
                                                    dtype=jnp.float32),
                           cache_pos=jnp.zeros(1, jnp.int32))
    with pytest.raises(ValueError, match="does not fit a cache of 4"):
        L.attention_apply(pt, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                          cache=L.init_attn_cache(cfg, 1, 4,
                                                  dtype=torch.float32),
                          cache_pos=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the kernel's plain version, its split and merge
# ---------------------------------------------------------------------------

def test_ref_at_one_query_is_the_decode_kernels():
    """At S 1 with slot t holding position t and the query at lengths - 1,
    the cache attention's plain version is the decode kernel's (out and
    lse), and both are the JAX package's decode reference."""
    b, t, h, hkv, d = 3, 40, 6, 2, 32
    q = torch.from_numpy(_rand(b, 1, h, d, seed=1))
    k = torch.from_numpy(_rand(b, t, hkv, d, seed=2))
    v = torch.from_numpy(_rand(b, t, hkv, d, seed=3))
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    k_pos = torch.arange(t, dtype=torch.int32)[None].expand(b, -1)
    got, lse = CA.cache_attention_ref(q, k, v, (lengths - 1)[:, None], k_pos,
                                      return_lse=True)
    want, want_lse = decode_attention_ref(q[:, 0], k, v, lengths,
                                          return_lse=True)
    _close(got[:, 0], want, 1e-5)
    _close(lse[:, 0], want_lse, 1e-5)
    jq = np.asarray(q[:, 0].numpy())
    jk = np.swapaxes(k.repeat_interleave(h // hkv, 2).numpy(), 1, 2)
    jv = np.swapaxes(v.repeat_interleave(h // hkv, 2).numpy(), 1, 2)
    jout = jax_decode_ref(jnp.asarray(jq), jnp.asarray(jk), jnp.asarray(jv),
                          jnp.asarray(lengths.numpy()))
    _close(got[:, 0], jout, 1e-5)


def test_ref_masks_as_jax_with_window_and_unwritten_slots():
    """``cache_attention_ref`` against the JAX package's grouped_attention
    with its cached mask (position mask, window, slots at -1), an
    all-masked row included."""
    b, s, t, h, hkv, d, w = 2, 5, 12, 4, 2, 32, 3
    q = _rand(b, s, h, d, seed=4)
    k = _rand(b, t, hkv, d, seed=5)
    v = _rand(b, t, hkv, d, seed=6)
    k_pos = np.random.default_rng(7).permutation(t).astype(np.int32) - 2
    k_pos = np.stack([k_pos, np.full(t, -1, np.int32)])  # row 1: none
    q_pos = np.stack([np.arange(3, 3 + s)] * b).astype(np.int32)
    mask = JL._causal_window_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), w)
    mask &= jnp.asarray(k_pos >= 0)[:, None, :]
    want = JL.grouped_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask[:, None], d)
    got, lse = CA.cache_attention_ref(*(torch.from_numpy(a) for a in (
        q, k, v, q_pos, k_pos)), window=w, return_lse=True)
    _close(got, want, 1e-5)
    # the dead row reads the mean of V over the slots; its lse is -inf
    _close(got[1], np.broadcast_to(v[1].mean(0).repeat(h // hkv, 0),
                                   (s, h, d)), 1e-5)
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()


@pytest.mark.parametrize("n", [2, 4])
def test_slices_merged_by_lse_give_the_whole_cache(n):
    """What the mesh does: the cache cut into n T-slices, each read with
    ``return_lse`` and the outputs merged by ``merge_weights`` with the
    slices' slot counts, is the read over the whole cache, a row with no
    live slot on any slice (the mean over every slot) and one with live
    slots on one slice only included."""
    b, s, t, h, hkv, d = 2, 4, 16, 2, 1, 32
    q, k, v = (torch.from_numpy(_rand(*sh, seed=i)) for i, sh in enumerate(
        ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))))
    k_pos = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1) + 10
    q_pos = torch.tensor([[9, 10, 13, 30], [11, 12, 25, 26]],
                         dtype=torch.int32)
    want = CA.cache_attention_ref(q, k, v, q_pos, k_pos)
    step = t // n
    outs, lses = zip(*(CA.cache_attention_ref(
        q, k[:, i:i + step], v[:, i:i + step], q_pos, k_pos[:, i:i + step],
        return_lse=True) for i in range(0, t, step)))
    w = merge_weights(torch.stack(lses), torch.full((n,), step))
    got = (w[..., None] * torch.stack(outs)).sum(0)
    _close(got, want, 1e-5)
    assert torch.isneginf(torch.stack(lses)[:, 0, 0]).all()
    assert float(merge_weights(torch.stack(lses))[:, 0, 0].sum()) == 0.0


def test_split_plan_fills_the_sms_and_splits_only_short_grids():
    f32, bf16 = torch.float32, torch.bfloat16
    # SmolLM's segment: 480 CUDA-core blocks / 240 wgmma blocks, no split
    assert CA.split_plan(8, 256, 15, 5, 1064, 64, f32) == 1088
    assert CA.split_plan(8, 256, 15, 5, 1064, 64, bf16) == 1088
    # zamba2's: 128 / 64 blocks, two chunks of 3 x 64 / 2 x 128 slots
    assert CA.split_plan(2, 64, 32, 32, 328, 112, f32) == 192
    assert CA.split_plan(2, 64, 32, 32, 328, 112, bf16) == 256
    # mixtral's ring: 128 f32 blocks, one a SM, no split; 64 wgmma, two
    assert CA.split_plan(1, 256, 32, 8, 4096, 128, f32) == 4096
    assert CA.split_plan(1, 256, 32, 8, 4096, 128, bf16) == 2048
    assert CA.split_plan(1, 1, 8, 8, 33, 64, f32) == 64       # capped by T


def test_cpu_wrapper_refuses_a_non_positive_window():
    z = torch.zeros(1, 1, 1, 32)
    p = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="window must be positive"):
        CA.cache_attention(z, z, z, p, p, window=0)


# ---------------------------------------------------------------------------
# Model.prefill twice, then decode, every attention family
# ---------------------------------------------------------------------------

def _models(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, lm_params_from_numpy(tree, cfg, device="cpu")


def _batch(cfg, s, seed, image=True):
    rng = np.random.default_rng(seed)
    shape = (B, s, cfg.n_codebooks) if cfg.family == "audio" else (B, s)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.frontend_tokens if image else 0
        nb["image_embeds"] = rng.standard_normal(
            (B, p, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


#: (arch, config overrides, segments, max_len): the prompt as segments of
#: these lengths, then decode steps
FAMILY_RUNS = {
    "smollm-360m": ({}, (6, 5, 4), 24),
    "mixtral-8x7b": (dict(sliding_window=8, capacity_factor=2.0),
                     (6, 5, 11), 40),
    "granite-moe-1b-a400m": ({}, (5, 7), 20),
    "llava-next-mistral-7b": ({}, (6, 4), 40),
    "musicgen-medium": ({}, (5, 6), 20),
    "zamba2-7b": ({}, (7, 5), 20),
}


@pytest.mark.parametrize("arch", list(FAMILY_RUNS))
def test_model_prefill_in_segments_then_decode_matches_jax(arch):
    """A prompt in several ``prefill`` calls on one cache (mixtral's 8-slot
    ring wrapped by its second and overrun by its third), then four decode
    steps: every call's logits, the positions, against the JAX package."""
    kw, segments, max_len = FAMILY_RUNS[arch]
    jm, params, model = _models(arch, **kw)
    cfg = model.cfg
    jc = jm.init_cache(B, max_len + cfg.frontend_tokens, dtype=jnp.float32)
    tc = model.init_cache(B, max_len + cfg.frontend_tokens,
                          dtype=torch.float32)
    for i, s in enumerate(segments):
        jb, tb = _batch(cfg, s, seed=i, image=i == 0)
        want, jc = jm.prefill(params, jb, jc, dtype=jnp.float32)
        got, tc = model.prefill(tb, tc, dtype=torch.float32)
        _close(got, want)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
    rng = np.random.default_rng(9)
    for _ in range(4):
        shape = (B, cfg.n_codebooks) if cfg.family == "audio" else (B,)
        tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        want, jc = jm.decode_step(params, jnp.asarray(tok), jc,
                                  dtype=jnp.float32)
        got, tc = model.decode_step(torch.from_numpy(tok), tc,
                                    dtype=torch.float32)
        _close(got, want)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(want).argmax(-1))


# ---------------------------------------------------------------------------
# the same segments on a 2 x 2 mesh of four gloo ranks
# ---------------------------------------------------------------------------

_MESH = r'''
import dataclasses, json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from torch.distributed.tensor import Shard
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.models.transformer import Model
from repro_torch.utils.dist import dtensor_collectives, gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")
#: case -> (window, max_len, segment lengths), B 4 (batch over 'data')
CASES = {"a": (None, 16, (6, 5, 4)), "a_overflow": (None, 16, (12, 6)),
         "b": (8, 32, (6, 5, 4)), "c": (8, 32, (13,)),
         "c_continue": (8, 32, (3, 11))}


def run(case):
    window, max_len, segs = CASES[case]
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_heads=4, n_kv_heads=2, head_dim=32,
                              sliding_window=window)
    dt = torch.float32
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, s)).astype(np.int32))} for s in segs]
    ref = Model(cfg, device="cpu", seed=0)
    c1 = ref.init_cache(4, max_len, dtype=dt)
    want = []
    for bt in batches:
        l1, c1 = ref.prefill(bt, c1, dt)
        want.append(l1)
    pre = specs.build_case_from_cfg(cfg, "prefill_32k", mesh,
                                    compute_dtype=dt)
    model = Model(cfg, device="cpu", seed=0)
    p_sh = sh.params_shardings(model.tree(), cfg, mesh, mode="serve")
    model.load_tree(sh.distribute(model.tree(), p_sh, mesh, dm))
    params = model.weights(dt)
    cache = model.init_cache(4, max_len, dtype=dt)
    cache = sh.distribute(cache, sh.cache_shardings(cache, cfg, mesh),
                          mesh, dm)
    axes = sh.pick_batch_axes(mesh, 4, allow_model=False)
    k0 = cache["blocks"][0]["k"]
    held = {k0.to_local().untyped_storage().data_ptr()}
    shard = int(np.prod(k0.to_local().shape))
    got, gathers = [], []
    with activation_sharding(mesh, axes, dm):
        for bt in batches:
            with dtensor_collectives() as (mode, calls):
                l2, cache = pre["fn"](params, bt, cache)
            gathers += [list(c.shape) for c in calls if "gather" in c.name
                        and (c.storage in held
                             or int(np.prod(c.shape)) == shard)]
            got.append(l2.full_tensor())
    errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(got, want)]
    pos = [cache["blocks"][i]["pos"].full_tensor()
           for i in range(cfg.n_layers)]
    return dict(logit_err=errs,
                pos_equal=all(torch.equal(p, c["pos"])
                              for p, c in zip(pos, c1["blocks"])),
                t_split=isinstance(k0.placements[1], Shard),
                slots=[int(k0.shape[1]), int(k0.to_local().shape[1])],
                cache_gathers=gathers)


with gloo_collectives():
    results = {case: run(case) for case in sys.argv[4].split(",")}
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''
MESH_CASES = ("a", "a_overflow", "b", "c", "c_continue")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("segments"), MESH_CASES, _MESH)


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_segments_match_one_device(mesh_runs, case):
    """Each prefill call on the 2 x 2 mesh (the cache's T split over
    'model', each rank writing and reading its own slice) against one
    device: logits within 1e-4 x max(1, max |logit|), every layer's
    positions equal, no cache shard all-gathered."""
    r = mesh_runs[case]
    assert r["t_split"] and r["slots"][1] * 2 == r["slots"][0]
    assert max(r["logit_err"]) <= RTOL, r["logit_err"]
    assert r["pos_equal"]
    assert r["cache_gathers"] == []
