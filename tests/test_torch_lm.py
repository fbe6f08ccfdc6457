"""The port's LM serving path against the JAX package on the CPU.

Each ported module (norms, rope, MLPs, ``attention_apply`` with no cache,
prefill and decode), the whole ``Model.apply``, the ``Engine.generate``
logits per step and its tokens, ``sample_logits`` and
``lm_params_from_numpy`` run on the same weights (the JAX model's random
init, converted) and inputs (numpy, from a seed).  The attention core runs
the kernels' plain versions on the CPU; the JAX model runs its jnp attention.
The model tests use a reduced SmolLM with GQA (4 heads, 2 kv heads).

Tolerance: 1e-4 x max(1, max |value|) in f32 (float32 matmuls and a
softmax summed in another order); sampled tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import sample_logits as jax_sample_logits
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.serve import Engine, ServeConfig, sample_logits
from repro_torch.utils import prng

RTOL = 1e-4
B, PROMPT, NEW = 2, 8, 6


def _cfgs(arch="smollm-360m", **kw):
    """The same reduced config in both packages (GQA for smollm)."""
    if arch == "smollm-360m":
        kw = dict(dict(n_heads=4, n_kv_heads=2), **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _close(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=RTOL * scale, rtol=0)


def _models(arch="smollm-360m", **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, lm_params_from_numpy(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def smollm():
    return _models()


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm(kind):
    x = _rand(2, 5, 16)
    p = {"scale": _rand(16, seed=1)}
    if kind == "layer":
        p["bias"] = _rand(16, seed=2)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), kind)
    _close(got, want)


def test_apply_rope():
    x = _rand(2, 7, 3, 32)
    pos = (np.arange(7)[None] + np.array([[0], [1000]])).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(mlp):
    jcfg, cfg = _cfgs(mlp=mlp)
    p = jax.tree_util.tree_map(np.asarray,
                               JL.mlp_init(jax.random.PRNGKey(1), jcfg))
    x = _rand(2, 5, cfg.d_model)
    want = JL.mlp_apply(jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x), jcfg)
    got = L.mlp_apply({k: torch.tensor(v) for k, v in p.items()},
                      torch.from_numpy(x), cfg)
    _close(got, want)


def _attn_params(jcfg):
    p = jax.tree_util.tree_map(
        np.asarray, JL.attention_init(jax.random.PRNGKey(2), jcfg))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            {k: torch.tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("window", [None, 4])
def test_attention_apply_full_sequence(window):
    jcfg, cfg = _cfgs()
    pj, pt = _attn_params(jcfg)
    x = 0.5 * _rand(B, 12, cfg.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    want, _ = JL.attention_apply(pj, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 window=window)
    got, cache = L.attention_apply(pt, torch.from_numpy(x), cfg,
                                   torch.from_numpy(pos.copy()),
                                   window=window)
    assert cache is None
    _close(got, want)


def test_attention_apply_prefill_then_decode():
    """Prefill writes the cache through the dynamic-slice branch and reads
    the new k/v only; decode writes one slot and reads cache_pos + 1."""
    jcfg, cfg = _cfgs()
    pj, pt = _attn_params(jcfg)
    t, s = 16, 6
    x = 0.5 * _rand(B, s + 3, cfg.d_model, seed=3)
    cj = JL.init_attn_cache(jcfg, B, t, dtype=jnp.float32)
    ct = L.init_attn_cache(cfg, B, t, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    zero = np.zeros(B, np.int32)
    want, cj = JL.attention_apply(pj, jnp.asarray(x[:, :s]), jcfg,
                                  jnp.asarray(pos), cache=cj,
                                  cache_pos=jnp.asarray(zero))
    got, ct = L.attention_apply(pt, torch.from_numpy(x[:, :s].copy()), cfg,
                                torch.from_numpy(pos), cache=ct,
                                cache_pos=torch.from_numpy(zero))
    _close(got, want)
    for i in range(3):
        p = np.full((B, 1), s + i, np.int32)
        cp = np.full(B, s + i, np.int32)
        xi = x[:, s + i:s + i + 1].copy()
        want, cj = JL.attention_apply(pj, jnp.asarray(xi), jcfg,
                                      jnp.asarray(p), cache=cj,
                                      cache_pos=jnp.asarray(cp))
        got, ct = L.attention_apply(pt, torch.from_numpy(xi), cfg,
                                    torch.from_numpy(p), cache=ct,
                                    cache_pos=torch.from_numpy(cp))
        _close(got, want)
    for name in ("k", "v"):
        _close(ct[name], cj[name])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("prefill", [1, 3, 4])
def test_attention_apply_ring_decode_matches_jax(prefill):
    """A ring of window 4 slots: a prefill of 1, 3 or 4 tokens (4 fills
    it, through the S == T branch), then one token a step; each step
    writes slot pos % 4 and reads the min(pos + 1, 4) written slots, the
    JAX package's position mask over the ring."""
    jcfg, cfg = _cfgs()
    pj, pt = _attn_params(jcfg)
    w, n = 4, 12
    x = 0.5 * _rand(B, n, cfg.d_model, seed=5)
    cj = JL.init_attn_cache(jcfg, B, 16, window=w, dtype=jnp.float32)
    ct = L.init_attn_cache(cfg, B, 16, window=w, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()
    spans = [(0, prefill)] + [(i, i + 1) for i in range(prefill, n)]
    for a, e in spans:
        cp = np.full(B, a, np.int32)
        want, cj = JL.attention_apply(
            pj, jnp.asarray(x[:, a:e]), jcfg, jnp.asarray(pos[:, a:e]),
            window=w, cache=cj, cache_pos=jnp.asarray(cp))
        got, ct = L.attention_apply(
            pt, torch.from_numpy(x[:, a:e].copy()), cfg,
            torch.from_numpy(pos[:, a:e].copy()), window=w, cache=ct,
            cache_pos=torch.from_numpy(cp))
        _close(got, want)
    assert ct["k"].shape[1] == w
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "granite-3-2b", "gemma-2b",
                                  "starcoder2-15b"])
def test_model_apply_logits(arch):
    jm, params, model = _models() if arch == "smollm-360m" else _models(arch)
    tok = _tokens(model.cfg.vocab_size, (B, 11))
    want, _ = jm.apply(params, {"tokens": jnp.asarray(tok)}, train=False)
    FA.reset_counts()
    got, aux = model.apply({"tokens": torch.from_numpy(tok)})
    assert aux == {} and FA.COUNTS["flash_attention"] == 0
    _close(got, want)
    _close(model.features({"tokens": torch.from_numpy(tok)}),
           jm.features(params, {"tokens": jnp.asarray(tok)}))


def test_lm_params_from_numpy_stacked_and_list_forms_agree():
    jcfg, cfg = _cfgs(scan_layers=True)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(np.asarray, params)
    assert isinstance(stacked["blocks"], dict)
    listed = dict(stacked, blocks=[
        jax.tree_util.tree_map(lambda a, i=i: a[i], stacked["blocks"])
        for i in range(cfg.n_layers)])
    tok = _tokens(cfg.vocab_size, (B, 9))
    want, _ = jm.apply(params, {"tokens": jnp.asarray(tok)}, train=False)
    for tree in (stacked, listed):
        model = lm_params_from_numpy(tree, cfg, device="cpu")
        _close(model.apply({"tokens": torch.from_numpy(tok)})[0], want)
    bad = dict(listed, blocks=listed["blocks"][:1])
    with pytest.raises(ValueError, match="blocks"):
        lm_params_from_numpy(bad, cfg, device="cpu")


def _jax_generate_logits(jm, params, tok, sc):
    """The JAX Engine's loop, keeping the logits of every step."""
    cache = jm.init_cache(tok.shape[0], sc.max_len, dtype=jnp.float32)
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(tok)}, cache,
                               dtype=jnp.float32)
    key = jax.random.PRNGKey(sc.seed)
    key, sub = jax.random.split(key)
    nxt = jax_sample_logits(logits, sub, sc.temperature, sc.top_k)
    seen = [np.asarray(logits)]
    for _ in range(NEW - 1):
        logits, cache = jm.decode_step(params, nxt, cache, dtype=jnp.float32)
        key, sub = jax.random.split(key)
        nxt = jax_sample_logits(logits, sub, sc.temperature, sc.top_k)
        seen.append(np.asarray(logits))
    return np.stack(seen, axis=1)


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 20)])
def test_engine_generate_matches_jax(smollm, temperature, top_k):
    jm, params, model = smollm
    tok = _tokens(model.cfg.vocab_size, (B, PROMPT), seed=4)
    kw = dict(max_len=PROMPT + NEW + 8, temperature=temperature, top_k=top_k)
    jsc = JaxServeConfig(**kw)
    want_tokens = JaxEngine(jm, jsc).generate(
        params, {"tokens": jnp.asarray(tok)}, n_new=NEW)
    DA.reset_counts()
    got_tokens, logits = Engine(model, ServeConfig(**kw)).generate(
        {"tokens": torch.from_numpy(tok)}, n_new=NEW, return_logits=True)
    assert DA.COUNTS["decode_attention"] == 0
    np.testing.assert_array_equal(got_tokens, np.asarray(want_tokens))
    _close(logits, _jax_generate_logits(jm, params, tok, jsc))


def test_engine_refuses_a_cache_too_small(smollm):
    model = smollm[2]
    tok = torch.zeros((1, 10), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_len"):
        Engine(model, ServeConfig(max_len=12)).generate({"tokens": tok},
                                                        n_new=4)


@pytest.mark.parametrize("shape", [(8, 512), (4, 4, 512)])  # audio: (B, C, V)
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (1.0, 0), (0.7, 5),
                                               (1.3, 50)])
def test_sample_logits_token_equal_to_jax(temperature, top_k, shape):
    logits = 3.0 * _rand(*shape, seed=5)
    for seed in range(3):
        want = jax_sample_logits(jnp.asarray(logits),
                                 jax.random.PRNGKey(seed), temperature, top_k)
        got = sample_logits(torch.from_numpy(logits), prng.PRNGKey(seed),
                            temperature, top_k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prng_uniform_range_and_categorical_match_jax():
    key = jax.random.PRNGKey(7)
    want = jax.random.uniform(key, (4, 300), minval=-2.0, maxval=3.0)
    got = prng.uniform(prng.PRNGKey(7), (4, 300), minval=-2.0, maxval=3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = _rand(6, 40, seed=6)
    want = jax.random.categorical(key, jnp.asarray(logits), axis=-1)
    got = prng.categorical(prng.PRNGKey(7), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_weights_cast_once_per_dtype(smollm):
    model = smollm[2]
    w1 = model.weights(torch.bfloat16)
    assert model.weights(torch.bfloat16) is w1
    assert w1["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert w1["final_norm"]["scale"].dtype == torch.float32
    assert model.weights(torch.float32)["embed"] is model.embed_table
