"""The port's other model families against the JAX package on the CPU.

MoE (mixtral-8x7b, granite-moe-1b-a400m), vlm (llava-next-mistral-7b),
audio (musicgen-medium), rwkv6 (rwkv6-7b) and the mamba2 hybrid
(zamba2-7b), each at its ``reduced()`` size, run on the same weights (the
JAX model's random init, converted) and inputs (numpy, from a seed) in
both packages.  Attention runs the kernels' plain versions on the CPU.

Tolerances: model logits 1e-4 x max(1, max |logit|) (float32 matmuls and
softmaxes summed in another order); ``moe_apply`` 1e-5 x max(1, max |y|),
its ``moe_lb`` and ``moe_z`` rtol 1e-5 and ``moe_drop_frac`` equal (the
same assignments are dropped); the wkv and SSD scans 1e-5 x max(1, max
|y|) (float32 einsums); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ALL_ARCHS as JAX_ARCHS
from repro.configs.base import get_config as jax_get_config
from repro.models import mamba2 as JM2
from repro.models import moe as JMOE
from repro.models import rwkv6 as JR6
from repro.models.transformer import build_model as jax_build_model
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.serve import Engine, ServeConfig

RTOL = 1e-4
FAMILIES = ["mixtral-8x7b", "granite-moe-1b-a400m", "llava-next-mistral-7b",
            "musicgen-medium", "rwkv6-7b", "zamba2-7b"]
B, PROMPT, NEW = 2, 16, 6


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _models(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, lm_params_from_numpy(tree, cfg, device="cpu")


_CACHE = {}


def _family(arch):
    if arch not in _CACHE:
        _CACHE[arch] = _models(arch)
    return _CACHE[arch]


def _batch(cfg, s=PROMPT, seed=0):
    """The family's batch in both packages: tokens (B, S) (audio: (B, S,
    C)); vlm also image embeddings (B, P, D)."""
    rng = np.random.default_rng(seed)
    shape = (B, s, cfg.n_codebooks) if cfg.family == "audio" else (B, s)
    np_batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}
    if cfg.family == "vlm":
        np_batch["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_all_archs_are_the_jax_packages():
    assert ALL_ARCHS == JAX_ARCHS


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_config_equals_jax_field_by_field(arch):
    for reduce in (False, True):
        want = jax_get_config(arch)
        got = get_config(arch)
        if reduce:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
    model = build_model(get_config(arch).reduced(), device="cpu")
    assert model.cfg.name == arch + "-reduced"


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw,capacity", [
    ("mixtral-8x7b", {}, None),                      # top-2 of 4, drops
    ("mixtral-8x7b", {}, 64),                        # dropless (decode)
    ("mixtral-8x7b", dict(capacity_factor=0.25), None),   # heavy drops
    ("granite-moe-1b-a400m", dict(n_experts=16, top_k=8), None),
    ("granite-moe-1b-a400m", dict(n_experts=16, top_k=8), 64),
    ("granite-moe-1b-a400m", dict(mlp="gelu"), None)])
def test_moe_apply_matches_jax(arch, kw, capacity):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               JMOE.moe_init(jax.random.PRNGKey(3), jcfg))
    x = _rand(4, 16, cfg.d_model, seed=1, scale=0.5)
    want, jaux = JMOE.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), jcfg,
                                capacity_override=capacity)
    got, aux = MOE.moe_apply({k: torch.tensor(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg,
                             capacity_override=capacity)
    _close(got, want, 1e-5)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    if capacity is not None:
        assert float(aux["moe_drop_frac"]) == 0.0
    elif "capacity_factor" in kw:
        assert float(aux["moe_drop_frac"]) > 0.0


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = MOE.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# the chunked scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(48, 1), (48, 4), (48, 16), (48, 48),
                                     (48, 64),    # s < chunk: chunks of 1
                                     (48, 20)])   # odd: one chunk of s
def test_wkv_chunked_matches_jax(s, chunk):
    b, h, n = 2, 3, 8
    r, k, v = (_rand(b, s, h, n, seed=i) for i in range(3))
    w = np.random.default_rng(3).uniform(0.2, 0.999, (b, s, h, n)).astype(
        np.float32)
    u, s0 = _rand(h, n, seed=4), _rand(b, h, n, n, seed=5)
    yj, fj = JR6._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)),
                              chunk)
    yt, ft = R6._wkv_chunked(*(torch.from_numpy(a)
                               for a in (r, k, v, w, u, s0)), chunk)
    _close(yt, yj, 1e-5)
    _close(ft, fj, 1e-5)


@pytest.mark.parametrize("chunk", [1, 4, 16, 48])
def test_ssd_chunked_matches_jax(chunk):
    b, t, h, p, g, n = 2, 48, 4, 8, 2, 6
    x = _rand(b, t, h, p, seed=0)
    dt = np.random.default_rng(1).uniform(0.01, 0.2, (b, t, h)).astype(
        np.float32)
    Bm, Cm = _rand(b, t, g, n, seed=2), _rand(b, t, g, n, seed=3)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    s0 = _rand(b, h, p, n, seed=4)
    for state0 in (None, s0):
        args = (x, dt, Bm, Cm, A)
        yj, fj = JM2.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                                 None if state0 is None
                                 else jnp.asarray(state0))
        yt, ft = M2.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                                None if state0 is None
                                else torch.from_numpy(state0))
        _close(yt, yj, 1e-5)
        _close(ft, fj, 1e-5)


@pytest.mark.parametrize("s", [1, 37, 48])
def test_mamba2_apply_matches_jax(s):
    """Odd lengths fall back to one chunk of S (1 at S = 1), with and
    without the carried conv and SSM state."""
    jcfg = jax_get_config("zamba2-7b").reduced()
    cfg = get_config("zamba2-7b").reduced()
    p = jax.tree_util.tree_map(np.asarray,
                               JM2.mamba2_init(jax.random.PRNGKey(1), jcfg))
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = {k: torch.tensor(v) for k, v in p.items()}
    x = _rand(2, s, cfg.d_model, seed=s)
    want, _ = JM2.mamba2_apply(pj, jnp.asarray(x), jcfg)
    got, _ = M2.mamba2_apply(pt, torch.from_numpy(x), cfg)
    _close(got, want, 1e-5)
    st = JM2.init_mamba_state(jcfg, 2, jnp.float32)
    st = {"conv": st["conv"] + 0.3, "ssm": st["ssm"] + 0.1}
    want, wst = JM2.mamba2_apply(pj, jnp.asarray(x), jcfg, st)
    got, gst = M2.mamba2_apply(pt, torch.from_numpy(x), cfg,
                               {k: torch.tensor(np.asarray(v))
                                for k, v in st.items()})
    _close(got, want, 1e-5)
    for k in ("conv", "ssm"):
        _close(gst[k], wst[k], 1e-5)


# ---------------------------------------------------------------------------
# each family's model, prefill, decode and generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_apply_logits(arch):
    jm, params, model = _family(arch)
    jb, tb = _batch(model.cfg, s=24)
    want, jaux = jm.apply(params, jb, train=False)
    FA.reset_counts()
    got, aux = model.apply(tb)
    assert FA.COUNTS["flash_attention"] == 0
    _close(got, want)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    _close(model.features(tb), jm.features(params, jb))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_then_decode(arch):
    jm, params, model = _family(arch)
    cfg = model.cfg
    jb, tb = _batch(cfg)
    max_len = cfg.frontend_tokens + PROMPT + 8
    jc = jm.init_cache(B, max_len, dtype=jnp.float32)
    tc = model.init_cache(B, max_len, dtype=torch.float32)
    want, jc = jm.prefill(params, jb, jc, dtype=jnp.float32)
    got, tc = model.prefill(tb, tc, dtype=torch.float32)
    _close(got, want)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    rng = np.random.default_rng(7)
    for _ in range(4):
        shape = (B, cfg.n_codebooks) if cfg.family == "audio" else (B,)
        tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        want, jc = jm.decode_step(params, jnp.asarray(tok), jc,
                                  dtype=jnp.float32)
        got, tc = model.decode_step(torch.from_numpy(tok), tc,
                                    dtype=torch.float32)
        _close(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_generate_tokens_equal_jax(arch):
    jm, params, model = _family(arch)
    cfg = model.cfg
    jb, tb = _batch(cfg, seed=4)
    kw = dict(max_len=cfg.frontend_tokens + PROMPT + NEW + 8)
    want = JaxEngine(jm, JaxServeConfig(**kw)).generate(params, jb,
                                                        n_new=NEW)
    DA.reset_counts()
    got = Engine(model, ServeConfig(**kw)).generate(tb, n_new=NEW)
    assert DA.COUNTS["decode_attention"] == 0
    want = np.asarray(want)
    assert got.shape == want.shape == ((B, NEW, cfg.n_codebooks)
                                       if cfg.family == "audio"
                                       else (B, NEW))
    np.testing.assert_array_equal(got, want)


def test_bf16_weights_keep_the_rwkv_decay_lora_in_f32():
    """The JAX package reads the rwkv decay LoRA in float32 whatever the
    activation dtype (``_decay``); the model's bf16 copy keeps it so."""
    w = _family("rwkv6-7b")[2].weights(torch.bfloat16)["blocks"][0]
    assert w["time_mix"]["decay_lora_a"].dtype == torch.float32
    assert w["time_mix"]["decay_lora_b"].dtype == torch.float32
    assert w["time_mix"]["w_r"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the ring-buffer window cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill", [1, 4, 8])
def test_ring_decode_matches_jax(prefill):
    """Reduced mixtral with window 8: a ring of 8 slots, a prefill of 1, 4
    or 8 tokens (8 fills it), then one token a step up to 24 tokens, the
    ring wrapping twice; every step's logits against the JAX package's
    decode, and against its full-sequence forward with the window (every
    token routed, capacity factor E / k, so the forward drops none)."""
    jm, params, model = _models("mixtral-8x7b", sliding_window=8,
                                capacity_factor=2.0)
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (1, 24)).astype(np.int32)
    full, _ = jm.apply(params, {"tokens": jnp.asarray(toks)}, train=False)
    jc = jm.init_cache(1, 64, dtype=jnp.float32)
    tc = model.init_cache(1, 64, dtype=torch.float32)
    assert tc["blocks"][0]["k"].shape[1] == 8
    first = {"tokens": toks[:, :prefill]}
    want, jc = jm.prefill(params, {"tokens": jnp.asarray(first["tokens"])},
                          jc, dtype=jnp.float32)
    got, tc = model.prefill({"tokens": torch.from_numpy(first["tokens"])},
                            tc, dtype=torch.float32)
    _close(got, want)
    for t in range(prefill, 24):
        want, jc = jm.decode_step(params, jnp.asarray(toks[:, t]), jc,
                                  dtype=jnp.float32)
        got, tc = model.decode_step(torch.from_numpy(toks[:, t]), tc,
                                    dtype=torch.float32)
        _close(got, want)
        _close(got, full[:, t])
    np.testing.assert_array_equal(tc["blocks"][0]["pos"].numpy(),
                                  np.asarray(jc["blocks"][0]["pos"]))


# ---------------------------------------------------------------------------
# convert: the stacked (scan) and list layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("rwkv6-7b", {}),
    ("zamba2-7b", dict(n_layers=8, shared_attn_period=3)),   # 2 tail blocks
    ("zamba2-7b", {}),                                        # no tail
    ("musicgen-medium", {}),
    ("granite-moe-1b-a400m", {})])
def test_convert_stacked_and_list_forms_agree(arch, kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               scan_layers=True, **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), scan_layers=True,
                              **kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(np.asarray, params)
    assert isinstance(stacked["blocks"], dict)
    jb, tb = _batch(cfg, s=12)
    want, _ = jm.apply(params, jb, train=False)
    # the list form: the JAX package's own unstacked init of the same key
    jl = jax_build_model(dataclasses.replace(jcfg, scan_layers=False))
    listed = jax.tree_util.tree_map(np.asarray,
                                    jl.init(jax.random.PRNGKey(0)))
    assert isinstance(listed["blocks"], list)
    for tree in (stacked, listed):
        model = lm_params_from_numpy(tree, cfg, device="cpu")
        _close(model.apply(tb)[0], want)


def test_convert_refuses_a_wrong_depth():
    jm, params, _ = _family("rwkv6-7b")
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="blocks"):
        lm_params_from_numpy(dict(tree, blocks=tree["blocks"][:1]),
                             get_config("rwkv6-7b").reduced(), device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_unseeded_model_draws_nothing(arch, monkeypatch):
    """``seed=None`` (what a load overwrites) allocates the tree of seed
    0's shapes without drawing a random number."""
    cfg = get_config(arch).reduced()
    want = {k: v.shape for k, v in build_model(
        cfg, device="cpu", seed=0).state_dict().items()}

    def refuse(*args, **kwargs):
        raise AssertionError("an unseeded model drew random weights")
    monkeypatch.setattr(torch, "randn", refuse)
    got = build_model(cfg, device="cpu", seed=None).state_dict()
    assert {k: v.shape for k, v in got.items()} == want


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_serve_launcher_runs_every_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--arch", arch, "--local", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--new-tokens", "3"])
    cfg = get_config(arch)
    want = "(2, 3, 4)" if cfg.family == "audio" else "(2, 3)"
    assert f"generated: {want}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_launcher_runs_every_family_on_the_cpu(arch, capsys):
    from repro_torch.launch.train import main as train_main
    train_main(["--arch", arch, "--local", "--device", "cpu", "--steps",
                "2", "--seq", "32", "--batch", "2"])
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "nan" not in out
