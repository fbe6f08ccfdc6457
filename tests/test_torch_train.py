"""The port's LM training against the JAX package's, on the CPU.

Mirrors ``tests/test_train.py``'s optimizer, schedule, loss-decrease,
MoE auxiliary-loss and token-stream tests on the port (its checkpoint
tests are in ``tests/test_torch_checkpoint.py``) and holds the port
against the JAX package on the same inputs:

  * ``TokenStream`` batches equal bit for bit (dense, audio and vlm
    layouts);
  * ``next_token_loss`` on random logits, dense, vlm (text positions only)
    and audio (codebooks summed): rtol 1e-6 (a float32 logsumexp and mean
    in another order);
  * ``AdamW`` (with clipping, a schedule, and bf16 parameters under f32
    masters) and ``SGD`` over several steps of the same gradients: rtol
    1e-6 / atol 1e-7 (the same float32 arithmetic; XLA may contract a
    multiply-add);
  * the differentiable ``flash_mha`` (GQA, a window) against ``jax.grad``
    of the JAX package's attention oracle: 1e-5 x max(1, max |g|);
  * one ``train_step`` on a reduced SmolLM with the same weights: ``ce``,
    ``loss`` and ``grad_norm`` rtol 1e-5; every gradient within 1e-4 of
    its leaf's largest |g| (float32 backpropagation through two layers,
    summed in another order); the updated parameters equal to the port's
    AdamW applied to the port's gradients bit for bit, and within 1e-3 x lr
    of the JAX step wherever |g| >= 1e-5.  AdamW's first step moves a
    weight by lr * (g / (|g| + eps) + wd * p), and the unit step
    g / (|g| + eps) turns steeply where |g| nears eps = 1e-8: there gradients
    within 1e-4 of the leaf's scale (~1e-2) move it by up to 1e-2 (1.6e-6
    in a weight at lr 3e-4, measured), so those weights are held only to
    the step's own bound, 2 x lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data.tokens import DataConfig as JaxDataConfig
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models.transformer import build_model as jax_build_model
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.losses import next_token_loss as jax_next_token_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.tokens import DataConfig, TokenStream
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import build_model
from repro_torch.train.losses import next_token_loss
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_eval_step, make_grad_fn,
                                    make_train_step)
from repro_torch.train.optimizer import (AdamW, SGD, clip_by_global_norm,
                                         cosine_schedule, global_norm,
                                         tree_leaves, tree_map)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


# -- optimizer semantics (tests/test_train.py) -------------------------------

def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2.0 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_weight_decay_shrinks():
    opt = AdamW(lr=0.01, weight_decay=0.5, clip_norm=None)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    for _ in range(50):
        params, state = opt.update({"w": torch.zeros(4)}, state, params)
    assert float(params["w"][0]) < 1.0


def test_sgd_momentum_moves():
    opt = SGD(lr=0.1, momentum=0.9)
    params = {"w": torch.tensor(5.0)}
    state = opt.init(params)
    for _ in range(100):
        params, state = opt.update({"w": params["w"]}, state, params)
    assert abs(float(params["w"])) < 0.1


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    np.testing.assert_allclose(float(global_norm(clip_by_global_norm(g,
                                                                     1.0))),
                               1.0, rtol=1e-5)
    # below the threshold: unchanged
    small = {"a": torch.full((4,), 0.01), "b": torch.full((9,), 0.01)}
    np.testing.assert_allclose(clip_by_global_norm(small, 1.0)["a"].numpy(),
                               small["a"].numpy())


def test_cosine_schedule_shape():
    fn = cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)
    lrs = [fn(s) for s in [0, 5, 10, 50, 100, 200]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-3)


def test_token_stream_deterministic_and_bounded():
    cfg = get_config("gemma-2b").reduced()
    a = list(TokenStream(cfg, DataConfig(seq_len=16, batch_size=2,
                                         seed=3)).batches(2))
    b = list(TokenStream(cfg, DataConfig(seq_len=16, batch_size=2,
                                         seed=3)).batches(2))
    np.testing.assert_array_equal(a[0]["tokens"], b[0]["tokens"])
    assert a[0]["tokens"].max() < cfg.vocab_size
    assert a[0]["tokens"].min() >= 0


def test_train_loss_decreases_smollm_reduced():
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    tc = TrainConfig(lr=1e-3)
    params, opt_state = init_train_state(model, tc)
    step = make_train_step(model, tc)
    stream = TokenStream(cfg, DataConfig(seq_len=64, batch_size=8))
    losses = []
    for batch in stream.batches(30):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses[:3]


def test_bf16_master_weights_train_and_eval_steps():
    """bf16 compute with f32 masters: the matrices live in bf16, the
    optimizer's masters in float32, and the loss still falls."""
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    tc = TrainConfig(lr=1e-3, compute_dtype=torch.bfloat16,
                     master_weights=True)
    params, opt_state = init_train_state(model, tc)
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert opt_state.master["blocks"][0]["attn"]["wq"].dtype == torch.float32
    step = make_train_step(model, tc)
    batches = list(TokenStream(cfg, DataConfig(seq_len=32,
                                               batch_size=4)).batches(12))
    losses = []
    for batch in batches:
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    # the bf16 weights are the masters rounded
    torch.testing.assert_close(
        params["blocks"][1]["mlp"]["w_up"],
        opt_state.master["blocks"][1]["mlp"]["w_up"].to(torch.bfloat16),
        rtol=0, atol=0)
    ev = make_eval_step(model, tc)(params, batches[0])
    assert set(ev) == {"ce", "loss"} and np.isfinite(float(ev["ce"]))


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "audio", "vlm"])
def test_token_stream_matches_jax(family):
    kw = {"dense": {}, "audio": dict(family="audio", n_codebooks=4),
          "vlm": dict(family="vlm", frontend_tokens=5)}[family]
    jcfg = dataclasses.replace(jax_get_config("smollm-360m").reduced(), **kw)
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), **kw)
    mine = list(TokenStream(cfg, DataConfig(seq_len=24, batch_size=3,
                                            seed=7)).batches(3))
    theirs = list(JaxTokenStream(jcfg, JaxDataConfig(
        seq_len=24, batch_size=3, seed=7)).batches(3))
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_next_token_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    cfg = get_config("smollm-360m").reduced()
    jcfg = jax_get_config("smollm-360m").reduced()
    logits = (3 * rng.normal(size=(2, 9, cfg.vocab_size))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    aux = {"moe_lb": 0.25, "moe_z": 0.125, "router_entropy": 3.0}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jl = jnp.asarray(logits).astype(jdt)
    tl = _t(logits).to(dtype)
    jt, jm = jax_next_token_loss(jcfg, jl, {"tokens": jnp.asarray(toks)},
                                 {k: jnp.float32(v) for k, v in aux.items()})
    tt, tm = next_token_loss(cfg, tl, {"tokens": toks},
                             {k: torch.tensor(v) for k, v in aux.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tt) == pytest.approx(float(tm["ce"]) + 0.375, rel=1e-6)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "musicgen-medium"])
def test_next_token_loss_vlm_and_audio_match_jax(arch):
    """The vlm and audio losses against the JAX package's: vlm over the
    text positions after the image prefix, audio the codebooks' CE
    summed."""
    rng = np.random.default_rng(1)
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, (2, 9, cfg.n_codebooks))
        shape = (2, 9, cfg.n_codebooks, cfg.vocab_size)
    else:
        toks = rng.integers(0, cfg.vocab_size, (2, 9))
        shape = (2, cfg.frontend_tokens + 9, cfg.vocab_size)
    toks = toks.astype(np.int32)
    logits = (3 * rng.normal(size=shape)).astype(np.float32)
    aux = {"moe_lb": 0.25}
    jt, jm = jax_next_token_loss(jcfg, jnp.asarray(logits),
                                 {"tokens": jnp.asarray(toks)},
                                 {k: jnp.float32(v) for k, v in aux.items()})
    tt, tm = next_token_loss(cfg, _t(logits), {"tokens": toks},
                             {k: torch.tensor(v) for k, v in aux.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)


def _trees(rng, bf16=False):
    shapes = {"a": (3, 4), "b": [{"c": (5,)}, {"c": (2, 2)}]}

    def draw(shape):
        return rng.normal(size=shape).astype(np.float32)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return draw(s)
    return build(shapes), [build(shapes) for _ in range(4)]


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("kind", ["adamw", "adamw_schedule_clip",
                                  "adamw_bf16_masters", "sgd_clip"])
def test_optimizer_updates_match_jax(kind):
    rng = np.random.default_rng(3)
    params, grads = _trees(rng)
    lr = cosine_schedule(0.05, 2, 6)
    jlr = jopt.cosine_schedule(0.05, 2, 6)
    bf16 = kind == "adamw_bf16_masters"
    if kind.startswith("adamw"):
        kw = dict(weight_decay=0.1, clip_norm=(0.5 if "clip" in kind
                                                else None),
                  master_weights=bf16)
        mine = AdamW(lr=lr if "schedule" in kind else 0.05, **kw)
        theirs = jopt.AdamW(lr=jlr if "schedule" in kind else 0.05, **kw)
    else:
        mine = SGD(lr=0.05, momentum=0.9, clip_norm=0.5)
        theirs = jopt.SGD(lr=0.05, momentum=0.9, clip_norm=0.5)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    # a copy: the port's update works in place, and the numpy arrays may
    # back the JAX arrays too
    tp = _as(params, lambda a: _t(a, tdt).clone())
    jp = _as(params, lambda a: jnp.asarray(a).astype(jdt))
    ts, js = mine.init(tp), theirs.init(jp)
    leaves = tree_leaves(tp)
    for g in grads:
        tp, ts = mine.update(_as(g, lambda a: _t(a, tdt)), ts, tp)
        assert all(a is b for a, b in zip(tree_leaves(tp), leaves))
        jp, js = theirs.update(_as(g, lambda a: jnp.asarray(a).astype(jdt)),
                               js, jp)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(_np(a), _np(b), **OPT_TOL)
    assert ts.step == int(js.step) == len(grads)
    if bf16:
        for a, b in zip(tree_leaves(ts.master),
                        jax.tree_util.tree_leaves(js.master)):
            np.testing.assert_allclose(_np(a), _np(b), **OPT_TOL)


def test_cosine_schedule_matches_jax():
    mine = cosine_schedule(3e-4, warmup=7, total=50, min_frac=0.1)
    theirs = jopt.cosine_schedule(3e-4, warmup=7, total=50, min_frac=0.1)
    for s in range(0, 60, 3):
        assert mine(s) == pytest.approx(float(theirs(jnp.asarray(s))),
                                        rel=1e-6, abs=0)


@pytest.mark.parametrize("h,hkv,window", [(4, 2, None), (4, 1, 5),
                                          (2, 2, None)])
def test_flash_mha_gradients_match_jax(h, hkv, window):
    """The differentiable ``flash_mha`` (on the CPU: the plain version in
    the forward pass and the plain recompute in the backward pass) against
    ``jax.grad`` of the JAX package's attention oracle, GQA by repeating
    the kv heads."""
    rng = np.random.default_rng(1)
    b, s, d = 2, 12, 16
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    g = rng.normal(size=(b, s, h, d)).astype(np.float32)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = flash_mha(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(
        _np(out), _np(attention_ref(tq, tk, tv, window=window)), rtol=0,
        atol=0)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))

    def jax_loss(q_, k_, v_):
        rep = h // hkv
        heads = lambda x: jnp.moveaxis(x, 2, 1)   # noqa: E731
        o = jax_attention(heads(q_), heads(jnp.repeat(k_, rep, axis=2)),
                          heads(jnp.repeat(v_, rep, axis=2)), causal=True,
                          window=window)
        return jnp.sum(jnp.moveaxis(o, 1, 2) * g)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    for a, bb in zip(grads, jgrads):
        want = np.asarray(bb)
        np.testing.assert_allclose(
            _np(a), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def jax_and_port_models():
    jcfg = jax_get_config("smollm-360m").reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, jm, params, tree


def test_train_step_matches_jax(jax_and_port_models):
    jcfg, jm, jparams, tree = jax_and_port_models
    cfg = get_config("smollm-360m").reduced()
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    batch = next(TokenStream(cfg, DataConfig(seq_len=32, batch_size=4,
                                             seed=2)).batches(1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtc, tc = jloop.TrainConfig(), TrainConfig()

    def jax_loss(p):
        logits, aux = jm.apply(p, jbatch, train=True, dtype=jnp.float32)
        return jax_next_token_loss(jcfg, logits, jbatch, aux)

    (_, jmetrics), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jparams)
    jnew, _, jstep_metrics = jloop.make_train_step(jm, jtc)(
        jparams, jloop.make_optimizer(jtc).init(jparams), jbatch)

    params, opt_state = init_train_state(model, tc)
    grads, metrics = make_grad_fn(model, tc)(params, batch)
    for k in ("ce", "loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jstep_metrics["grad_norm"]), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tree_leaves(grads)) == len(jleaves)
    for a, b in zip(tree_leaves(grads), jleaves):
        want = np.asarray(b)
        assert a.shape == want.shape
        np.testing.assert_allclose(_np(a), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))

    # the update works in place: the port's AdamW applied to a copy
    ref_opt = AdamW(lr=tc.lr, weight_decay=tc.weight_decay,
                    clip_norm=tc.clip_norm)
    want = tree_map(lambda p: p.detach().clone(), params)
    ref_opt.update(grads, ref_opt.init(want), want)
    params, opt_state, step_metrics = make_train_step(model, tc)(
        params, opt_state, batch)
    assert opt_state.step == 1
    assert params["embed"] is model.embed_table   # updated in place
    for k in ("ce", "loss", "grad_norm"):
        np.testing.assert_allclose(float(step_metrics[k]),
                                   float(jstep_metrics[k]), rtol=1e-5)
    for a, w, b, g in zip(tree_leaves(params), tree_leaves(want),
                          jax.tree_util.tree_leaves(jnew), jleaves):
        np.testing.assert_array_equal(_np(a), _np(w))
        diff = np.abs(_np(a) - np.asarray(b))
        steep = np.abs(np.asarray(g)) < 1e-5
        assert diff[~steep].max(initial=0) <= 1e-3 * tc.lr
        assert diff[steep].max(initial=0) <= 2 * tc.lr


def test_train_step_moe_aux_losses_match_jax():
    """The counterpart of ``tests/test_train.py::
    test_train_step_moe_aux_losses_present``: one step of the reduced
    granite-moe on the same weights and batch; ``ce``, ``loss``,
    ``moe_lb``, ``moe_z`` and ``grad_norm`` within rtol 1e-5 of the JAX
    step's, ``moe_drop_frac`` equal (the same assignments dropped), and
    ``moe_lb`` > 0."""
    jcfg = jax_get_config("granite-moe-1b-a400m").reduced()
    cfg = get_config("granite-moe-1b-a400m").reduced()
    jm = jax_build_model(jcfg)
    jtc, tc = jloop.TrainConfig(), TrainConfig()
    jparams, jopt = jloop.init_train_state(jm, jtc, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 cfg, device="cpu")
    batch = next(TokenStream(cfg, DataConfig(seq_len=32,
                                             batch_size=4)).batches(1))
    _, _, jmetrics = jloop.make_train_step(jm, jtc)(
        jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    params, opt_state = init_train_state(model, tc)
    _, _, metrics = make_train_step(model, tc)(params, opt_state, batch)
    assert float(metrics["moe_lb"]) > 0.0
    for k in ("ce", "loss", "moe_lb", "moe_z", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(metrics["moe_drop_frac"]) == float(jmetrics["moe_drop_frac"])


def test_launch_train_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main as train_main
    from repro_torch.train.checkpoint import latest_step
    train_main(["--arch", "smollm-360m", "--local", "--device", "cpu",
                "--steps", "3", "--seq", "16", "--batch", "2",
                "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    2 loss=" in out and "saved:" in out
    assert latest_step(str(tmp_path)) == 3
    for flag in ("--dry-run", "--multi-pod"):
        with pytest.raises(SystemExit):
            train_main(["--arch", "smollm-360m", flag])
