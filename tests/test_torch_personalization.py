"""The port's ``PersonalizationBridge`` against the JAX package's.

Mirrors ``tests/test_personalization.py`` (features pooled and normalised,
the federation's layout, fit and predict) and
``tests/test_serve.py::test_personalization_bridge_end_to_end`` on the port,
on the CPU, and holds the bridge against the JAX bridge on a reduced
SmolLM with the same weights (``convert.lm_params_from_numpy``):

  * features within 1e-4 x max(1, max |f|): the backbone's float32
    products and softmax summed in another order (the LM contract of
    ``tests/test_torch_lm.py``);
  * the federation's layout equal (shapes, labels, mask), its features as
    above;
  * ``fit`` on the same federation (the JAX bridge's features) within the
    MOCHA contract of ``tests/test_torch_mocha.py``: objectives rtol 1e-5
    / atol 1e-4 round by round, W and Omega atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.configs.base import get_config as jax_get_config
from repro.core.personalization import \
    PersonalizationBridge as JaxPersonalizationBridge
from repro.models.transformer import build_model as jax_build_model
import repro_torch.core as tc
from repro_torch.configs import get_config
from repro_torch.convert import federation_from_numpy, lm_params_from_numpy
from repro_torch.core.personalization import PersonalizationBridge
from repro_torch.models import build_model

M_TASKS, SEQ = 3, 16
FEAT_RTOL = 1e-4


def _close(got, want, rtol=FEAT_RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _mocha(pkg, **kw):
    return pkg.MochaConfig(**dict(dict(loss="smooth_hinge", rounds=8,
                                       record_every=4), **kw))


@pytest.fixture(scope="module")
def setup():
    """The JAX bridge and the port's on the same reduced SmolLM weights;
    per-task batches of unbalanced sizes (as the paper's n_t)."""
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 get_config("smollm-360m").reduced(),
                                 device="cpu")
    reg = dict(lam=1e-2, sigma2=10.0)
    jbridge = JaxPersonalizationBridge(jmodel, jc.Probabilistic(**reg),
                                       _mocha(jc))
    bridge = PersonalizationBridge(model, tc.Probabilistic(**reg),
                                   _mocha(tc, device="cpu"))
    rng = np.random.default_rng(0)
    batches, labels = [], []
    for t in range(M_TASKS):
        n = 4 + 2 * t
        batches.append({"tokens": rng.integers(0, jcfg.vocab_size,
                                               (n, SEQ)).astype(np.int32)})
        labels.append(np.sign(np.arange(n) % 2 - 0.5))
    return jcfg, params, jbridge, bridge, batches, labels


def test_features_pooled_and_normalized(setup):
    cfg, _, _, bridge, batches, _ = setup
    feats = bridge.features(batches[0])
    assert feats.shape == (4, cfg.d_model) and feats.dtype == torch.float32
    assert bool(torch.isfinite(feats).all())
    np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=-1),
                               1.0, atol=1e-4)
    # normalize=False keeps the raw pooled scale
    raw = dataclasses.replace(bridge, normalize=False)
    assert not np.allclose(
        torch.linalg.vector_norm(raw.features(batches[0]), dim=-1), 1.0)


def test_build_federation_layout(setup):
    cfg, _, _, bridge, batches, labels = setup
    fed = bridge.build_federation(batches, labels)
    n_max = max(b["tokens"].shape[0] for b in batches)
    assert fed.X.shape == (M_TASKS, n_max, cfg.d_model)
    assert fed.device == bridge.device
    np.testing.assert_array_equal(fed.n_t.numpy(),
                                  [b["tokens"].shape[0] for b in batches])
    # labels land left-packed, padding is masked out
    np.testing.assert_array_equal(fed.y[0, :4].numpy(), labels[0])
    assert float(fed.mask[0, 4:].max()) == 0.0


def test_fit_and_predict_roundtrip(setup):
    cfg, _, _, bridge, batches, labels = setup
    fed = bridge.build_federation(batches, labels)
    result = bridge.fit(fed)
    assert result.W.shape == (M_TASKS, cfg.d_model)
    assert np.isfinite(result.final("gap"))
    # training reduced the primal objective from the cold start
    assert result.history["primal"][-1] < result.history["primal"][0]
    # predict: per-task margins for new examples, consistent with features@w
    margins = bridge.predict(batches[1], result.W[1])
    assert margins.shape == (batches[1]["tokens"].shape[0],)
    manual = bridge.features(batches[1]) @ torch.from_numpy(result.W[1])
    np.testing.assert_allclose(margins.numpy(), manual.numpy(), rtol=1e-5)


def test_personalization_bridge_end_to_end():
    """Per-task heads over the frozen backbone separate each task's topic
    sequences from random ones (the JAX package's end-to-end check)."""
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)

    def task(topic):
        n, s = 16, 24
        labels = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        toks = np.zeros((n, s), np.int32)
        lo, hi = (0, cfg.vocab_size // 2) if topic else (
            cfg.vocab_size // 2, cfg.vocab_size)
        for i in range(n):
            toks[i] = (rng.integers(lo, hi, s) if labels[i] > 0
                       else rng.integers(0, cfg.vocab_size, s))
        return {"tokens": toks}, labels

    batches, labels = zip(*[task(t % 2) for t in range(4)])
    bridge = PersonalizationBridge(
        model, tc.Probabilistic(lam=1e-3, sigma2=10.0),
        tc.MochaConfig(loss="smooth_hinge", rounds=50,
                       omega_update_every=25,
                       budget=tc.BudgetConfig(passes=2.0), record_every=49,
                       device="cpu"))
    fed = bridge.build_federation(batches, labels)
    assert fed.m == 4 and fed.d == cfg.d_model
    res = bridge.fit(fed)
    accs = [float((torch.sign(bridge.predict(batches[t], res.W[t]))
                   == torch.from_numpy(labels[t]).float()).float().mean())
            for t in range(4)]
    assert np.mean(accs) > 0.7, accs


# -- against the JAX package -------------------------------------------------

def test_features_and_federation_match_jax(setup):
    _, params, jbridge, bridge, batches, labels = setup
    for b in batches:
        _close(bridge.features(b),
               jbridge.features(params, {"tokens": jnp.asarray(b["tokens"])}))
    jfed = jbridge.build_federation(
        params, [{"tokens": jnp.asarray(b["tokens"])} for b in batches],
        [jnp.asarray(lab) for lab in labels])
    fed = bridge.build_federation(batches, labels)
    assert fed.X.shape == jfed.X.shape
    _close(fed.X, jfed.X)
    np.testing.assert_array_equal(fed.y.numpy(), np.asarray(jfed.y))
    np.testing.assert_array_equal(fed.mask.numpy(), np.asarray(jfed.mask))
    assert fed.xnorm2 is None


def test_fit_and_predict_match_jax(setup):
    """``fit`` on the same federation (the JAX bridge's features, carried
    over as numpy) and ``predict`` of its heads, against the JAX bridge."""
    _, params, jbridge, bridge, batches, labels = setup
    jfed = jbridge.build_federation(
        params, [{"tokens": jnp.asarray(b["tokens"])} for b in batches],
        [jnp.asarray(lab) for lab in labels])
    fed = federation_from_numpy(np.asarray(jfed.X), np.asarray(jfed.y),
                                np.asarray(jfed.mask), device="cpu")
    jres, res = jbridge.fit(jfed), bridge.fit(fed)
    assert res.history["round"] == jres.history["round"]
    np.testing.assert_array_equal(res.history["time"], jres.history["time"])
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(res.history[k], jres.history[k],
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(res.W, np.asarray(jres.W), atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.omega, np.asarray(jres.omega), atol=1e-5,
                               rtol=0)
    for t, b in enumerate(batches):
        _close(bridge.predict(b, res.W[t]),
               jbridge.predict(params, {"tokens": jnp.asarray(b["tokens"])},
                               jres.W[t]))
