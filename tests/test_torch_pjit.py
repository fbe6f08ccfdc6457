"""``repro_torch.utils.pjit_utils`` against the JAX package's
``repro.utils.pjit_utils``, on the CPU.

JAX's ``constrain`` resolves a spec to a ``PartitionSpec`` and hands it to
``jax.lax.with_sharding_constraint``; the test patches that function to
return the spec it is given, and runs JAX's ``constrain`` under its
``activation_sharding`` with a stand-in mesh (``axis_names`` and
``devices.shape``, as ``test_torch_launch.py`` stands in for the
production meshes), so no 512-device backend is made.  The grid: every
spec the call sites pass (``models/layers.py``, ``models/moe.py``,
``models/rwkv6.py``, ``models/mamba2.py`` and ``models/transformer.py`` of
both packages, and the port's own pins of the heads, positions, tokens,
token shift and in_proj output), at each arch's widths and each shape of
``configs/shapes.py``, on pod16x16, pod2x16x16 and 2 x 2, with the batch
axes ``pick_batch_axes`` picks for the shape.  Specs are compared exactly.
"""
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.utils.pjit_utils as jpj
from repro_torch.configs import get_config
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.models import moe
from repro_torch.utils import pjit_utils as pj

MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2))}


def _recurrent_sites(cfg, b, s):
    """rwkv6's wkv sites (``models/rwkv6.py:130-131``, ``:139``,
    ``:158-161`` of the JAX package, at the chunk its scan takes) and the
    port's token shift; the hybrid's SSD sites (``models/mamba2.py:100-152``)
    and the port's pins of the in_proj output and of B and C repeated to
    the heads.  The block outputs (``transformer.py:104``, ``:121``) are
    the common (B, None, None) site."""
    B = pj.BATCH
    if cfg.block_type == "rwkv6":
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        q = 64 if s % 64 == 0 else (1 if s < 64 else s)
        return [((b, s, h, n), (B, None, "model", None)),    # r, k, v, log w
                ((b, h, n, n), (B, "model", None, None)),    # the state
                ((b, q, h, n), (B, None, "model", None)),    # a chunk's y
                ((b, s, cfg.d_model), (B, None, "model")),   # shift (port)
                ((b, cfg.d_model), (B, "model"))]            # x_prev (port)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = 1 if s == 1 else s
    c = s // q
    proj = 2 * h * p + 2 * cfg.ssm_groups * n + h
    return [((b, s, h, p), (B, None, "model", None)),        # x
            ((b, s, h), (B, None, "model")),                 # dt
            ((b, c, q, h, n), (B, None, None, "model", None)),   # B, C
            ((b, c, h, q, q), (B, None, "model", None, None)),   # m
            ((b, c, h, p, n), (B, None, "model", None, None)),   # s_chunk
            ((b, c, q, h, p), (B, None, None, "model", None)),   # y
            ((b, h, p, n), (B, "model", None, None)),        # the state
            ((b, s, h, n), (B, None, "model", None)),        # B, C (port)
            ((b, s, proj), (B, None, None))]                 # in_proj (port)


def _call_sites(cfg, shape, groups=1):
    """(shape, spec with the port's BATCH) of every constraint the step
    passes at ``cfg``'s widths and ``shape``'s size: the embedding, block
    output and logits of every family; the attention's (the dense
    family's, zamba2's shared block), MoE's (``models/moe.py:90``,
    ``:100``, ``:114``, ``:117``, ``:127`` of the JAX package, at the
    groups its rule picks from ``groups`` batch shards), audio's logits
    (``transformer.py:425``) and the recurrent scans'
    (``_recurrent_sites``)."""
    b, s = shape.global_batch, shape.seq_len
    h, hkv, d, v = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size
    B = pj.BATCH
    extra = []
    if cfg.block_type != "attention":
        extra = _recurrent_sites(cfg, b, s)
    if cfg.is_moe:
        e, t = cfg.n_experts, b * s
        g = 1 if t % groups or t // groups < e else groups
        tg = t // g
        c = min(moe.capacity(tg, cfg), tg * cfg.top_k)
        extra = [((g, tg, cfg.d_model), (B, None, None)),          # xt, y
                 ((g, e, c, cfg.d_model), (B, None, None, None)),  # in, out
                 ((g, e, c, cfg.d_ff), (B, None, None, "model"))]  # hidden
    if cfg.family == "audio":
        extra.append(((b, s, cfg.n_codebooks, v), (B, None, None, "model")))
    common = [
        ((b, s, cfg.d_model), (B, None, None)),          # embed, block out
        ((b, s, v), (B, None, "model")),                 # logits
        ((b, v), (B, "model")),                          # last-token logits
        ((b, s), (B, None)),                             # positions, tokens
        ((b,), (B,)),                                    # start positions
    ]
    if cfg.block_type == "rwkv6":
        return extra + common
    return extra + common + [
        ((b, s, h, d), (B, None, "model", None)),        # q heads (port)
        ((b, s, hkv, d), (B, None, "model", None)),      # kv heads (port)
        ((b, s, h * d), (B, None, None)),                # projections (port)
        ((b, s, h, d), (B, "model", None, None)),        # k, v repeated
        ((b, h, 1, s), (B, None, None, "model")),        # scores, probs
        ((b, 1, h, d), (B, None, None, None)),           # decode q and out
        ((b, s, hkv, d), (B, "model", None, None)),      # the cache read
    ]


def _jax_spec(mesh_name, axes, shape, spec):
    names, sizes = MESHES[mesh_name]
    mesh = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(sizes, np.int8))
    jspec = tuple(jpj.BATCH if e is pj.BATCH else e for e in spec)
    with mock.patch.object(jax.lax, "with_sharding_constraint",
                           lambda x, p: p):
        with jpj.activation_sharding(mesh, axes):
            got = jpj.constrain(types.SimpleNamespace(shape=shape), *jspec)
            ctx = (jpj.batch_shard_count(), jpj.current_batch_axes())
    return _normal(tuple(got)) + (None,) * (len(shape) - len(got)), ctx


def _normal(spec):
    return tuple(None if e is None else
                 ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_resolve_spec_matches_jax_constrain(arch, mesh_name):
    cfg = get_config(arch)
    names, sizes = MESHES[mesh_name]
    tm = tmesh.MeshSpec(names, sizes)
    n = 0
    for shape in SHAPES.values():
        axes = sh.pick_batch_axes(tm, shape.global_batch,
                                  allow_model=shape.kind == "train")
        groups = int(np.prod([tm.axis_sizes[a] for a in axes]))
        sites = _call_sites(cfg, shape, groups)
        for dims, spec in sites:
            want, ctx = _jax_spec(mesh_name, axes, dims, spec)
            got = pj.resolve_spec(dims, spec, names, tm.axis_sizes, axes)
            assert _normal(got) == want, (shape.name, dims, spec)
            with pj.activation_sharding(tm, axes):
                assert (pj.batch_shard_count(),
                        pj.current_batch_axes()) == ctx
            n += 1
    per_shape = {"attention": 12, "rwkv6": 5 + 5, "mamba2": 12 + 9}
    assert n == len(SHAPES) * (per_shape[cfg.block_type] + 3 * cfg.is_moe
                               + (cfg.family == "audio"))


@pytest.mark.parametrize("axes", [(), ("data",), ("model",),
                                  ("data", "model"), ("pod", "data")])
def test_batch_shard_count_matches_jax(axes):
    for name, (names, sizes) in MESHES.items():
        mesh = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(sizes, np.int8))
        with jpj.activation_sharding(mesh, axes):
            want = jpj.batch_shard_count()
        with pj.activation_sharding(tmesh.MeshSpec(names, sizes), axes):
            assert pj.batch_shard_count() == want, name
    assert pj.batch_shard_count() == jpj.batch_shard_count() == 1
    assert pj.current_batch_axes() is None


def test_resolution_rules():
    """BATCH stands for the batch axes; a used axis is dropped from later
    dims; only a prefix of candidates whose product divides is kept."""
    names, sizes = ("pod", "data", "model"), {"pod": 2, "data": 16,
                                              "model": 16}
    r = pj.resolve_spec
    assert r((64, 8), (pj.BATCH, "model"), names, sizes,
             ("pod", "data")) == (("pod", "data"), None)
    assert r((512, 32), (pj.BATCH, "model"), names, sizes,
             ("pod", "data", "model")) == (("pod", "data", "model"), None)
    assert r((2, 32), (pj.BATCH, "model"), names, sizes,
             ("pod", "data")) == (("pod",), ("model",))
    assert r((1, 15), (pj.BATCH, "model"), names, sizes,
             ("pod", "data")) == (None, None)
    assert r((4, 48), (None, ("data", "model")), names, sizes, ()) == (
        None, ("data",))


def test_constrain_off_a_mesh_is_the_identity():
    x = torch.randn(4, 3)
    assert pj.constrain(x, pj.BATCH, None) is x
    with pj.activation_sharding(tmesh.make_test_mesh(2, 2), ("data",)):
        assert pj.constrain(x, pj.BATCH, "model") is x
        assert pj.batch_shard_count() == 2
    assert pj.constrain(x, pj.BATCH, "model") is x
