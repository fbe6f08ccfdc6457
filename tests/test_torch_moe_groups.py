"""The port's grouped MoE routing against the JAX package's, on the CPU.

JAX's ``moe_apply`` splits the tokens into ``batch_shard_count()`` groups
(one where that count does not divide the tokens, or leaves a group fewer
tokens than experts) and routes each group into its own capacity buffer.
Both packages run here on one device under their own
``activation_sharding`` context on a 2 x 2 stand-in mesh, so that both
read the same G: JAX's with a stand-in mesh (``axis_names`` and
``devices.shape``) and ``jax.lax.with_sharding_constraint`` patched to
return its argument (no 4-device backend is made), the port's with no
device mesh (its constraints leave plain tensors as they are).

Cases: G 1, 2 and 4 (batch axes (), ('data',), ('data', 'model')), both
fallbacks to one group (G does not divide the tokens; fewer tokens a
group than experts), with and without ``capacity_override``, swiglu and
gelu experts.  Limits: y within 1e-5 x max(1, max |y|), ``moe_lb`` and
``moe_z`` within 1e-6, ``moe_drop_frac`` of as many dropped assignments
(and within 1e-6: a share of 14 assignments is rounded in each package's
own summation order).
"""
import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.pjit_utils as jpj
from repro.configs.base import get_config as jax_get_config
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as MOE
from repro_torch.utils import pjit_utils as pj

AXES = {1: (), 2: ("data",), 4: ("data", "model")}


def _both(arch, kw, axes, shape, capacity):
    """(port's y, aux, G), (JAX's y, aux, G) on the same weights and x."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    p = jax.tree_util.tree_map(np.asarray,
                               JMOE.moe_init(jax.random.PRNGKey(5), jcfg))
    x = (0.5 * np.random.default_rng(2).normal(
        size=shape + (cfg.d_model,))).astype(np.float32)
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((2, 2), np.int8))
    with mock.patch.object(jax.lax, "with_sharding_constraint",
                           lambda v, spec: v):
        with jpj.activation_sharding(stand_in, axes):
            want, jaux = JMOE.moe_apply(
                jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                jcfg, capacity_override=capacity)
            jg = jpj.batch_shard_count()
    with pj.activation_sharding(make_test_mesh(2, 2), axes):
        got, aux = MOE.moe_apply({k: torch.tensor(v) for k, v in p.items()},
                                 torch.from_numpy(x), cfg,
                                 capacity_override=capacity)
        groups = MOE.groups_for(shape[0] * shape[1], cfg.n_experts)
    return (got, aux, groups), (np.asarray(want), jaux, jg)


def _hold(got, want, top_k):
    (y, aux, _), (jy, jaux, _) = got, want
    assert y.shape == jy.shape
    scale = max(1.0, float(np.abs(jy).max()))
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-5 * scale, rtol=0)
    for k in ("moe_lb", "moe_z"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-6, k
    # the same number of assignments dropped (each mean of the keep mask
    # is rounded in its package's summation order where the count of
    # assignments is not a power of two)
    n = y.shape[0] * y.shape[1] * top_k
    assert round(float(aux["moe_drop_frac"]) * n) == round(
        float(jaux["moe_drop_frac"]) * n)
    assert abs(float(aux["moe_drop_frac"])
               - float(jaux["moe_drop_frac"])) <= 1e-6


@pytest.mark.parametrize("capacity", [None, 96])
@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {}),                                    # swiglu, top-2
    ("mixtral-8x7b", dict(capacity_factor=0.5)),             # drops a group
    ("granite-moe-1b-a400m", dict(n_experts=8, top_k=4)),
    ("granite-moe-1b-a400m", dict(mlp="gelu"))])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_moe_matches_jax(groups, arch, kw, capacity):
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    got, want = _both(arch, kw, AXES[groups], (4, 16), capacity)
    assert got[2] == groups and want[2] == groups
    _hold(got, want, cfg.top_k)
    if capacity is not None:
        assert float(got[1]["moe_drop_frac"]) == 0.0


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {}), ("granite-moe-1b-a400m", dict(mlp="gelu"))])
@pytest.mark.parametrize("why,axes,shape", [
    ("G does not divide the tokens", AXES[2], (1, 7)),
    ("G does not divide the tokens", AXES[4], (2, 3)),
    ("fewer tokens a group than experts", AXES[4], (4, 1)),
    ("fewer tokens a group than experts", AXES[2], (2, 3))])
def test_grouped_moe_falls_back_to_one_group_as_jax(arch, kw, why, axes,
                                                    shape):
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tokens = shape[0] * shape[1]
    count = int(np.prod([2 for _ in axes]))
    assert (tokens % count != 0) == (why == "G does not divide the tokens")
    assert (tokens % count == 0 and tokens // count < cfg.n_experts) == (
        why == "fewer tokens a group than experts")
    for capacity in (None, tokens):
        got, want = _both(arch, kw, axes, shape, capacity)
        assert got[2] == 1
        _hold(got, want, cfg.top_k)


def test_groups_change_the_routing():
    """With drops, G 4 routes another set of tokens than G 1 (capacity per
    group): the groups are part of the function, as in JAX."""
    kw = dict(capacity_factor=0.5)
    one, _ = _both("mixtral-8x7b", kw, AXES[1], (4, 16), None)
    four, _ = _both("mixtral-8x7b", kw, AXES[4], (4, 16), None)
    assert float(one[1]["moe_drop_frac"]) > 0.0
    assert not torch.allclose(one[0], four[0], atol=1e-6)
