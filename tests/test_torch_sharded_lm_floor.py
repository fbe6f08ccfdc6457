"""``repro_torch.examples.sharded_lm_floor``, the rounding-floor probe of
the sharded LM step, on four gloo ranks on the CPU under
``torch.distributed.run`` with ``--local`` (the reduced rwkv6 config at 1
and 2 layers, two perturbation seeds): its JSON line holds a row a run
with the mesh's errors a step and each seed's floor; at this size the
mesh meets the sharded example's limits and every floor is under them.
The perturbation itself: a model built under ``perturbed`` differs from
the unperturbed one by about ``PERTURB``, and the builder is restored.
``sharded_lm.held_limit``, the rule that holds rwkv6-7b's mesh rows by
their floor where PERF.md §2's limit is under it.  And rwkv6 at one narrow
width (d 256, 4 heads of 64) at depths 2, 8 and 14 in the JAX package and
in the port: the step-0 grad_norm and its floor grow with depth alike in
both.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro.train.losses import next_token_loss as jax_next_token_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import sharded_lm as S
from repro_torch.examples import sharded_lm_floor as F
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_grad_fn)
from repro_torch.train.optimizer import tree_leaves

from test_torch_sharded_lm import _launch


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    rc, text, _ = _launch(tmp_path_factory.mktemp("floor"),
                          "repro_torch.examples.sharded_lm_floor",
                          ["--device", "cpu", "--local"])
    assert rc == 0, text[-4000:]
    lines = [line for line in text.splitlines()
             if line.startswith('{"sharded_lm_floor"')]
    assert len(lines) == 1, text[-4000:]
    return json.loads(lines[0])["sharded_lm_floor"]


def test_probe_reports_every_run_beside_its_floors(report):
    assert report["ranks"] == 4 and report["gloo_collectives"] is True
    assert report["arch"] == "rwkv6-7b-reduced"
    assert report["seeds"] == list(F.LOCAL_SEEDS)
    kinds = [(r["kind"], r["layers"], r["dtype"]) for r in report["runs"]]
    want = ([("train", d, "bfloat16") for d in F.LOCAL_DEPTHS]
            + [("generate", d, dt) for d in F.LOCAL_DEPTHS
               for dt in ("float32", "bfloat16")])
    assert kinds == want


@pytest.mark.parametrize("kind", ["train", "generate"])
def test_probe_at_the_reduced_size_meets_the_limits(report, kind):
    for r in (r for r in report["runs"] if r["kind"] == kind):
        assert r["meets_limit"] and r["floor_under_limit"], r
        floors = (r["rel_err_floor"] if kind == "train"
                  else r["logit_err_floor"])
        assert sorted(floors) == [str(s) for s in F.LOCAL_SEEDS]
        for f in floors.values():
            errs = f["ce"] + f["grad_norm"] if kind == "train" else f
            assert all(np.isfinite(errs)) and len(errs) >= 2
        if kind == "generate" and r["dtype"] == "float32":
            assert r["tokens_equal"]


def test_perturbed_scales_each_weight_by_about_perturb():
    from repro_torch import models
    from repro_torch.examples.sharded_lm import local_cfg
    cfg = local_cfg("rwkv6-7b")
    build = models.build_model
    base = build(cfg, device="cpu", seed=0)
    with F.perturbed(1):
        moved = models.build_model(cfg, device="cpu", seed=0)
    again = models.build_model(cfg, device="cpu", seed=0)
    assert models.build_model is build
    rel = []
    for a, b, c in zip(base.parameters(), moved.parameters(),
                       again.parameters()):
        assert torch.equal(a, c)
        nz = a != 0
        rel.append(((b - a)[nz] / a[nz]).abs().flatten())
    rel = torch.cat(rel)
    assert 0 < float(rel.max()) < 10 * F.PERTURB
    assert 0.5 * F.PERTURB < float(rel.std()) < 2 * F.PERTURB


@pytest.mark.parametrize("limit,floor,want", [
    (5e-2, None, (5e-2, "PERF.md §2")),          # no floor measured
    (1e-4, 5e-5, (1e-4, "PERF.md §2")),          # floor under the limit
    (1e-4, 1e-4, (1e-4, "PERF.md §2")),
    (1e-4, 1.14e-3, (3 * 1.14e-3, "3 x floor")),  # the 32-layer f32 floor
    (5e-4, 4.71e-3, (3 * 4.71e-3, "3 x floor")),
])
def test_held_limit_is_the_limit_unless_the_floor_is_above_it(limit, floor,
                                                              want):
    got = S.held_limit(limit, floor)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


#: the narrow rwkv6: d 256, 4 heads of 64, at these depths
NARROW = dict(d_model=256, rwkv_head_dim=64)
DEPTHS = (2, 8, 14)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + F.PERTURB * rng.standard_normal(a.shape))
                   ).astype(a.dtype) if a.dtype == np.float32 else a, tree)


def _grad_norms(depth, tokens):
    """Step 0's grad_norm in both packages on the same weights, and its
    floor in each: the largest relative change over F.SEEDS when every
    weight is scaled by (1 + PERTURB x N(0, 1)) (numpy draws, the same
    weights in both)."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6-7b").reduced(),
                               n_layers=depth, **NARROW)
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              n_layers=depth, **NARROW)
    jm = jax_build_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0)))
    jbatch = {"tokens": jnp.asarray(tokens)}

    @jax.jit
    def jax_norm(p):
        def loss(p):
            logits, aux = jm.apply(p, jbatch, train=True, dtype=jnp.float32)
            return jax_next_token_loss(jcfg, logits, jbatch, aux)
        g = jax.grad(lambda p: loss(p)[0])(p)
        return jnp.sqrt(sum(jnp.sum(x * x)
                            for x in jax.tree_util.tree_leaves(g)))

    def port_norm(t):
        model = lm_params_from_numpy(t, cfg, device="cpu")
        tc = TrainConfig()
        params, _ = init_train_state(model, tc)
        g, _ = make_grad_fn(model, tc)(params,
                                       {"tokens": torch.from_numpy(tokens)})
        return float(torch.sqrt(sum((x.float() ** 2).sum()
                                    for x in tree_leaves(g))))

    norms = dict(jax=float(jax_norm(tree)), port=port_norm(tree))
    floors = {k: 0.0 for k in norms}
    for seed in F.SEEDS:
        t = _perturbed(tree, seed)
        for k, v in (("jax", float(jax_norm(t))), ("port", port_norm(t))):
            floors[k] = max(floors[k], abs(v - norms[k]) / norms[k])
    return norms, floors


@pytest.fixture(scope="module")
def depth_runs():
    tokens = np.random.default_rng(0).integers(0, 512, (2, 64)).astype(
        np.int32)
    return {d: _grad_norms(d, tokens) for d in DEPTHS}


def test_rwkv6_grad_norm_and_floor_grow_with_depth_as_in_jax(depth_runs):
    """The same function in both packages: step 0's grad_norm equal within
    1e-4 at each depth, and growing over 5x from 2 to 14 layers in both;
    its floor (a weight perturbation of float32's rounding) grows over 5x
    from 2 to 14 layers in both, each package's floor within two orders
    of magnitude of the other's at every depth (both are the rounding of
    one function, each package summing in its own order)."""
    for d in DEPTHS:
        norms, floors = depth_runs[d]
        assert norms["port"] == pytest.approx(norms["jax"], rel=1e-4), d
        for k in ("jax", "port"):
            assert 0 < floors[k] < 1e-3, (d, floors)
        ratio = floors["port"] / floors["jax"]
        assert 1e-2 < ratio < 1e2, (d, floors)
    for k in ("jax", "port"):
        first, last = depth_runs[DEPTHS[0]], depth_runs[DEPTHS[-1]]
        assert last[0][k] > 5 * first[0][k]
        assert last[1][k] > 5 * first[1][k]
