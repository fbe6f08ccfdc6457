"""The sharded train step held against the JAX package's own sharded step.

The JAX package's ``launch.specs.build_case_from_cfg(cfg, "train_4k",
make_test_mesh(2, 2), jnp.float32)["fn"]``, jitted with the case's
``in_shardings`` and ``out_shardings`` inside ``activation_sharding``,
runs on a forced 2 x 2 host mesh (a process of its own, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and the root
``conftest.py``'s JAX 0.9 shim) from ``init_train_state``'s weights.  The
port's step (``repro_torch.launch.specs.build_case_from_cfg``'s ``fn``)
runs on four gloo ranks on the same weights (``convert.
lm_params_from_numpy``) and batch, placed by the port's plan.  Held: ce
and grad_norm within rtol 1e-5, and every updated leaf within 1e-5 x
max(1, max |w|) of JAX's, or 2 x lr where the gradient nears AdamW's eps
(|g| < 1e-5, the port's one-device gradient), as
``test_torch_mesh_step.py`` holds the mesh against one device.  Reduced
smollm-360m at B 4 x 64 and rwkv6-7b at B 4 x 128 (two 64-token wkv
chunks), their layers stacked as at full size (``scan_layers``), f32.
Nothing of the JAX package changes for it.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_mesh_step import _spawn

ROOT = Path(__file__).resolve().parents[1]
#: arch -> the step's sequence length
CASES = {"smollm-360m": 64, "rwkv6-7b": 128}
JAX_LIMIT_S = 240

_JAX = r'''
import dataclasses, pickle, sys
from jax._src.interpreters import batching as _batching
if not hasattr(type(_batching.primitive_batchers), "setdefault"):
    type(_batching.primitive_batchers).setdefault = (
        lambda self, key, value: value)
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.specs import build_case_from_cfg
from repro.train.loop import TrainConfig, init_train_state
from repro.utils.pjit_utils import activation_sharding
arch, seq, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert jax.device_count() == 4, jax.devices()
cfg = dataclasses.replace(get_config(arch).reduced(), scan_layers=True)
mesh = make_test_mesh(2, 2)
case = build_case_from_cfg(cfg, "train_4k", mesh, jnp.float32)
params, opt = init_train_state(case["model"], TrainConfig(),
                               jax.random.PRNGKey(0))
tokens = np.random.default_rng(3).integers(
    0, cfg.vocab_size, (4, seq)).astype(np.int32)
host = jax.tree_util.tree_map(np.asarray, params)
p_sh, o_sh, b_sh = case["in_shardings"]
with mesh, activation_sharding(mesh, case["batch_axes"]):
    step = jax.jit(case["fn"], in_shardings=case["in_shardings"],
                   out_shardings=case["out_shardings"])
    new, _, metrics = step(jax.device_put(params, p_sh),
                           jax.device_put(opt, o_sh),
                           jax.device_put({"tokens": jnp.asarray(tokens)},
                                          b_sh))
with open(out, "wb") as f:
    pickle.dump(dict(params=host, tokens=tokens,
                     new=jax.tree_util.tree_map(np.asarray, new),
                     ce=float(metrics["ce"]),
                     grad_norm=float(metrics["grad_norm"]),
                     batch_axes=list(case["batch_axes"])), f)
'''

_RANK = r'''
import dataclasses, json, pickle, sys
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_grad_fn, make_optimizer,
                                    make_trainable)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils.dist import gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")
results = {}
with gloo_collectives():
    for item in sys.argv[4].split(","):
        arch, path = item.split("=")
        with open(path, "rb") as f:
            j = pickle.load(f)
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  scan_layers=True)
        tc = TrainConfig()
        batch = {"tokens": torch.from_numpy(j["tokens"])}
        one = lm_params_from_numpy(j["params"], cfg, device="cpu")
        p1, _ = init_train_state(one, tc)
        g1, _ = make_grad_fn(one, tc)(p1, batch)

        case = specs.build_case_from_cfg(cfg, "train_4k", mesh,
                                         compute_dtype=torch.float32)
        p_sh = case["in_specs"][0]
        model = lm_params_from_numpy(j["params"], cfg, device="cpu")
        make_trainable(model, tc)
        model.load_tree(sh.distribute(model.tree(), p_sh, mesh, dm))
        opt = make_optimizer(tc).init(model.tree())
        axes = case["batch_axes"]
        placed = sh.distribute(batch, sh.batch_shardings(batch, mesh, axes),
                               mesh, dm)
        with activation_sharding(mesh, axes, dm):
            params, opt, m = case["fn"](model.tree(), opt, placed)
        want = lm_params_from_numpy(j["new"], cfg, device="cpu").tree()
        worst, steep = 0.0, 0.0
        for a, w, g in zip(tree_leaves(params), tree_leaves(want),
                           tree_leaves(g1)):
            d = (a.full_tensor() - w).detach().abs()
            flat = g.abs() < 1e-5
            scale = max(1.0, float(w.detach().abs().max()))
            worst = max(worst, float(torch.where(flat, 0, d).max()) / scale)
            steep = max(steep, float(torch.where(flat, d, 0).max()))
        results[arch] = dict(
            ce=[j["ce"], float(m["ce"])],
            grad_norm=[j["grad_norm"], float(m["grad_norm"])],
            batch_axes=[j["batch_axes"], list(axes)], leaf_err=worst,
            steep_err=steep, lr=tc.lr, leaves=len(tree_leaves(params)))
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    items = []
    for arch, seq in CASES.items():
        out = tmp / f"{arch}.pkl"
        proc = subprocess.run([sys.executable, "-c", _JAX, arch, str(seq),
                               str(out)], env=env, capture_output=True,
                              text=True, timeout=JAX_LIMIT_S)
        assert proc.returncode == 0, proc.stderr[-3000:]
        items.append(f"{arch}={out}")
    return _spawn(tmp, items, _RANK)


@pytest.mark.parametrize("arch", CASES)
def test_metrics_match_jax_on_the_mesh(runs, arch):
    r = runs[arch]
    assert r["batch_axes"] == [["data", "model"], ["data", "model"]]
    for k in ("ce", "grad_norm"):
        jax_value, port = r[k]
        assert abs(port - jax_value) <= 1e-5 * abs(jax_value), (k, r[k])


@pytest.mark.parametrize("arch", CASES)
def test_updated_leaves_match_jax_on_the_mesh(runs, arch):
    r = runs[arch]
    assert r["leaves"] > 0
    assert r["leaf_err"] <= 1e-5, r
    assert r["steep_err"] <= 2 * r["lr"], r
