"""The port's launch plan (shapes, meshes, sharding, specs, the dry-run and
the analytic roofline) against the JAX package's, on the CPU.

The JAX side runs through ``jax.eval_shape`` only: its ``params_shardings``
and friends see a stand-in mesh (``axis_names`` and ``devices.shape``) and
a ``NamedSharding`` that returns its bare spec, so no 512-device backend
is made.  ``repro.launch.dryrun`` and ``repro.launch.mocha_dryrun`` are
not imported (they set ``XLA_FLAGS`` when imported); ``repro.launch.
roofline`` is imported with ``XLA_FLAGS`` put back as it was.

The JAX package stacks each block leaf (a layer axis; zamba2's (periods,
period) with ``tail_blocks``; a cache per shared-attention call), the port
holds a list of layers: the JAX trees are unstacked as
``convert.lm_params_from_numpy`` unstacks weights, each leaf's spec losing
its stack entries, and held against the port's leaf by leaf.  Specs and
per-device bytes are compared exactly.
"""
import functools
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.sharding as jsh
import repro.launch.specs as jspecs
from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro_torch.configs import get_config
from repro_torch.configs import shapes
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.launch import dryrun, mesh as tmesh, roofline
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs
from repro_torch.models.transformer import Model

_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as jroofline  # noqa: E402
if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2))}
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


# -- the JAX side -------------------------------------------------------------

def _jax_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, np.int8))


def _bare_specs(fn, *args, **kw):
    """A JAX sharding function's result with bare PartitionSpecs."""
    with mock.patch.object(jsh, "NamedSharding", lambda mesh, spec: spec):
        return fn(*args, **kw)


class _Leaf(tuple):
    """(shape, dtype name, spec) of one JAX leaf."""


def _tree(shapes_tree, specs_tree):
    """The JAX tree with ``_Leaf`` leaves."""
    return jax.tree_util.tree_map(
        lambda s, spec: _Leaf((tuple(s.shape), np.dtype(s.dtype).name,
                               tuple(spec) + (None,) * (len(s.shape)
                                                        - len(spec)))),
        shapes_tree, specs_tree,
        is_leaf=lambda x: isinstance(x, P))


def _layer(tree, i):
    """Layer ``i`` of a stacked tree, each leaf losing its stack entry
    (the stack axis is never sharded)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    shape, dtype, spec = tree
    assert spec[0] is None and 0 <= i < shape[0], (tree, i)
    return _Leaf((shape[1:], dtype, spec[1:]))


def _unstack_params(tree, cfg):
    """The JAX parameter tree in the port's layout (as
    ``convert.lm_params_from_numpy`` unstacks it)."""
    tree = dict(tree)
    blocks, tail = tree["blocks"], tree.pop("tail_blocks", None)
    if isinstance(blocks, dict):
        if cfg.shared_attn_period:
            period = cfg.shared_attn_period
            n_periods = cfg.n_layers // period
            blocks = [_layer(_layer(blocks, i), j)
                      for i in range(n_periods) for j in range(period)]
            if tail is not None:
                blocks += [_layer(tail, j) for j in range(
                    cfg.n_layers - n_periods * period)]
        else:
            blocks = [_layer(blocks, i) for i in range(cfg.n_layers)]
    return dict(tree, blocks=blocks)


def _unstack_cache(tree, cfg):
    blocks = tree["blocks"]
    if not cfg.scan_layers:
        return tree
    if cfg.shared_attn_period:
        period = cfg.shared_attn_period
        n_periods = cfg.n_layers // period
        mamba = [_layer(_layer(blocks["mamba"], i), j)
                 for i in range(n_periods) for j in range(period)]
        if blocks["tail"] is not None:
            mamba += [_layer(blocks["tail"], j) for j in range(
                cfg.n_layers - n_periods * period)]
        blocks = {"mamba": mamba,
                  "shared": [_layer(blocks["shared"], j)
                             for j in range(n_periods)], "tail": None}
    else:
        blocks = [_layer(blocks, i) for i in range(cfg.n_layers)]
    return dict(tree, blocks=blocks)


def _jax_bytes(tree, sizes):
    """Per-device bytes of a ``_Leaf`` tree on a mesh of ``sizes``."""
    total = 0
    for shape, dtype, spec in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, _Leaf)):
        n = np.dtype(dtype).itemsize
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            k = math.prod(sizes[a] for a in axes)
            assert dim % k == 0
            n *= dim // k
        total += n
    return total


@functools.lru_cache(maxsize=None)
def _jax_state(arch, mode):
    """The JAX package's abstract parameters (and optimizer state), as
    ``build_case`` makes them: bf16 compute with float32 masters."""
    cfg = jax_get_config(arch)
    model = jax_build_model(cfg)
    if mode == "train":
        tc = JaxTrainConfig(compute_dtype=jnp.bfloat16, master_weights=True)
        return jspecs.model_state_specs(model, tc)
    return jspecs.serve_param_specs(model, jnp.bfloat16), None


def _port_tree(tree, specs_tree):
    """The port's tree with ``_Leaf`` leaves."""
    if isinstance(tree, dict):
        return {k: _port_tree(v, specs_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree(v, s) for v, s in zip(tree, specs_tree)]
    if tree is None:
        return None
    return _Leaf((tuple(tree.shape), str(tree.dtype).split(".")[-1],
                  specs_tree))


def _port_bytes(tree, specs_tree, name):
    return sh.shard_bytes(tree, specs_tree, tmesh.MeshSpec(*MESHES[name]))


# -- shapes, meshes, param_spec -----------------------------------------------

@pytest.mark.parametrize("name", SHAPES)
def test_shapes_equal_jax(name):
    assert shapes.get_shape(name).__dict__ == \
        jshapes.get_shape(name).__dict__
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    with pytest.raises(KeyError):
        shapes.get_shape("train_8k")


def test_meshes_are_the_jax_layouts():
    one = tmesh.make_production_mesh()
    two = tmesh.make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.size) == (("data", "model"),
                                                     (16, 16), 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert tmesh.data_axes(one) == ("data",)
    assert tmesh.data_axes(two) == ("pod", "data")
    assert tmesh.make_test_mesh().axis_sizes == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        tmesh.MeshSpec(("data",), (2, 2))


CFG = "llava-next-mistral-7b"


def test_param_spec_2d_weight():
    spec = sh.param_spec("blocks/attn/wq", (32, 4096, 4096),
                         get_config(CFG), 16, 16)
    assert spec in ((None, "model", "data"), (None, "data", "model"))


def test_param_spec_indivisible_falls_back():
    spec = sh.param_spec("w", (15, 7), get_config("smollm-360m"), 16, 16)
    assert spec == (None, None)


def test_param_spec_serve_mode_no_data_axis():
    spec = sh.param_spec("blocks/mlp/w_gate", (32, 4096, 14336),
                         get_config(CFG), 16, 16, use_data=False)
    assert "data" not in spec


def test_param_spec_vector_replicates():
    assert sh.param_spec("norm/scale", (4096,), get_config(CFG), 16,
                         16) == (None,)


@pytest.mark.parametrize("use_data", [True, False])
@pytest.mark.parametrize("data,model", [(16, 16), (2, 2), (4, 8), (3, 5)])
def test_param_spec_grid_matches_jax(data, model, use_data):
    rng = np.random.default_rng(data * 10 + model)
    dims = [1, 2, 3, 7, 15, 16, 32, 48, 64, 96, 112, 960, 4096, 14336]
    paths = ["w", "blocks/attn/wq", "tail_blocks/mamba/A_log",
             "shared_proj", "shared/mlp/w_up"]
    for arch in ("zamba2-7b", "smollm-360m"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for _ in range(60):
            shape = tuple(int(d) for d in rng.choice(dims,
                                                     rng.integers(1, 5)))
            for path in paths:
                want = jsh.param_spec(path, shape, jcfg, data, model,
                                      use_data=use_data)
                got = sh.param_spec(path, shape, cfg, data, model,
                                    use_data=use_data)
                assert got == tuple(want), (arch, path, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", SHAPES)
def test_pick_batch_axes_matches_jax(name, mesh):
    b = shapes.get_shape(name).global_batch
    for allow_model in (True, False):
        for batch in (b, 2 * b, 3, 1):
            assert sh.pick_batch_axes(tmesh.MeshSpec(*MESHES[mesh]), batch,
                                      allow_model) == \
                jsh.pick_batch_axes(_jax_mesh(mesh), batch, allow_model)


# -- the plan against JAX's, leaf by leaf -------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_and_optimizer_plan_matches_jax(arch, mode, mesh):
    """Every parameter (and optimizer) leaf: the JAX plan's spec with the
    stack entries dropped, and the JAX plan's per-device bytes exactly."""
    cfg = get_config(arch)
    jparams, jopt = _jax_state(arch, mode)
    jmesh, tm = _jax_mesh(mesh), tmesh.MeshSpec(*MESHES[mesh])
    j_sh = _bare_specs(jsh.params_shardings, jparams, jax_get_config(arch),
                       jmesh, mode=mode)
    model = Model(cfg, device="meta", seed=None)
    if mode == "train":
        tc = specs.TrainConfig(compute_dtype=torch.bfloat16,
                               master_weights=True)
        params, opt = specs.model_state_specs(model, tc)
    else:
        params, opt = specs.serve_param_specs(model), None
    p_sh = sh.params_shardings(params, cfg, tm, mode=mode)
    want = _unstack_params(_tree(jparams, j_sh), cfg)
    assert _port_tree(params, p_sh) == want
    sizes = tm.axis_sizes
    assert _port_bytes(params, p_sh, mesh) == _jax_bytes(want, sizes)
    if arch == "zamba2-7b":     # a per-layer vector, stacked in JAX
        assert p_sh["blocks"][0]["mamba"]["A_log"] == ("model",)
        assert p_sh["blocks"][80]["mamba"]["A_log"] == ("model",)
    if mode == "serve":
        return
    j_osh = _bare_specs(jsh.opt_shardings, jopt, j_sh, jmesh)
    o_sh = sh.opt_shardings(opt, p_sh)
    assert o_sh.step == () and opt.step.dtype == torch.int32
    for field in ("mu", "nu", "master"):
        got = _port_tree(getattr(opt, field), getattr(o_sh, field))
        want = _unstack_params(_tree(getattr(jopt, field),
                                     getattr(j_osh, field)), cfg)
        assert got == want, field
    jbytes = sum(_jax_bytes(_tree(getattr(jopt, f), getattr(j_osh, f)),
                            sizes) for f in ("mu", "nu", "master")) + 4
    assert _port_bytes(opt, o_sh, mesh) == jbytes


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_plan_matches_jax(arch, name):
    """Batch (or decode token) and cache leaves, on every mesh: specs and
    per-device bytes as JAX's, and ``build_case`` assembling them."""
    cfg, variant = specs.resolve_arch_for_shape(arch, name)
    jcfg, jvariant = jspecs.resolve_arch_for_shape(arch, name)
    assert variant == jvariant and cfg.sliding_window == jcfg.sliding_window
    shape = shapes.get_shape(name)
    if shape.kind != "train":
        cache = specs.cache_specs(Model(cfg, device="meta", seed=None),
                                  shape.global_batch, shape.seq_len)
        jcache = jspecs.cache_specs(jax_build_model(jcfg),
                                    shape.global_batch, shape.seq_len)
    for mesh in MESHES:
        jmesh, tm = _jax_mesh(mesh), tmesh.MeshSpec(*MESHES[mesh])
        sizes = tm.axis_sizes
        axes = sh.pick_batch_axes(tm, shape.global_batch,
                                  allow_model=shape.kind == "train")
        if shape.kind == "decode":
            batch = {"t": specs.decode_token_specs(cfg, shape)}
            jbatch = {"t": jspecs.decode_token_specs(jcfg, shape)}
        else:
            batch = specs.batch_specs(cfg, shape)
            jbatch = jspecs.batch_specs(jcfg, shape)
        b_sh = sh.batch_shardings(batch, tm, axes)
        jb_sh = _bare_specs(jsh.batch_shardings, jbatch, jmesh, axes)
        want = _tree(jbatch, jb_sh)
        assert _port_tree(batch, b_sh) == want, mesh
        assert _port_bytes(batch, b_sh, mesh) == _jax_bytes(want, sizes)
        case = specs.build_case(arch, name, tm)
        assert case["kind"] == shape.kind and case["variant"] == variant
        assert case["batch_axes"] == axes
        if shape.kind == "train":
            assert case["donate"] == (0, 1)
            assert case["in_specs"][2] == b_sh
            continue
        assert case["donate"] == (2,)
        c_sh = sh.cache_shardings(cache, cfg, tm)
        jc_sh = _bare_specs(jsh.cache_shardings, jcache, jcfg, jmesh)
        want = _unstack_cache(_tree(jcache, jc_sh), cfg)
        assert _port_tree(cache, c_sh) == want, mesh
        assert _port_bytes(cache, c_sh, mesh) == _jax_bytes(want, sizes)
        assert case["in_specs"][2] == c_sh
        b_case = case["in_specs"][1]
        assert b_case == (b_sh["t"] if shape.kind == "decode" else b_sh)


# -- the analytic roofline ----------------------------------------------------

@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_and_model_flops_match_jax(arch, name):
    for variant in (False, True):
        cfg = (specs.resolve_arch_for_shape(arch, name)[0] if variant
               else get_config(arch))
        jcfg = (jspecs.resolve_arch_for_shape(arch, name)[0] if variant
                else jax_get_config(arch))
        assert roofline.param_counts(cfg) == jroofline.param_counts(jcfg)
        assert roofline.model_flops(cfg, name) == \
            jroofline.model_flops(jcfg, name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_meta_model_counts_every_jax_parameter(arch):
    """The meta ``Model`` holds JAX's element count exactly and allocates
    nothing; ``param_counts`` leaves out the norms' and mixers' vectors
    (and the mamba convolutions): under 1e-3 of the total."""
    model = Model(get_config(arch), device="meta", seed=None)
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    jparams = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                             jax.random.PRNGKey(0))
    assert n == sum(math.prod(s.shape)
                    for s in jax.tree_util.tree_leaves(jparams))
    total, active = roofline.param_counts(get_config(arch))
    assert 0 <= n - total < 1e-3 * n


# -- the dry-run --------------------------------------------------------------

def test_local_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.MeshSpec(("pod", "data", "model"), (2, 4, 8))
    assert sh.local_shape((64, 24, 5), (("pod", "data"), "model", None),
                          m) == (8, 3, 5)
    assert sh.placements((("pod", "data"), "model", None), m) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.local_shape((6,), ("model",), m)
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"),), m)
    with pytest.raises(ValueError):
        sh.placements(("model", "model"), m)
    assert sh.replicated(2) == (None, None)


def test_run_case_record(tmp_path):
    rec = dryrun.run_case("zamba2-7b", "decode_32k", False, str(tmp_path),
                          device="cpu")
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    mem = rec["memory"]
    parts = [mem[f"{p}_bytes"] for p in ("params", "optimizer", "batch",
                                         "cache")]
    assert mem["argument_bytes"] == sum(parts) and parts[1] == 0
    assert mem["donated_bytes"] == mem["cache_bytes"] > 0
    assert rec["device_memory_bytes"] is None
    assert rec["fits_arguments"] is None
    # a plan-only record: the cost probe's fields null, the note says why
    for key in ("temp_bytes", "flops_device", "bytes_device", "collectives"):
        assert rec[key] is None
    assert "--costs" in rec["note"] and "not measured" in rec["note"]
    assert rec["model_flops"] == roofline.model_flops(
        get_config("zamba2-7b"), "decode_32k")
    assert (tmp_path / "zamba2-7b__decode_32k__pod16x16.json").exists()
    # with costs on the CPU: FLOPs, bytes and collectives a device filled
    # by the probe, temp bytes null with their reason (the card's only)
    costs = dryrun.run_case("mixtral-8x7b", "decode_32k", False,
                            str(tmp_path), device="cpu", costs=True)
    assert costs["status"] == "ok" and "note" not in costs
    assert costs["flops_device"] > 0 and costs["bytes_device"] > 0
    assert costs["collectives"]["count"] > 0
    assert costs["collectives"]["total"] > 0
    assert costs["temp_bytes"] is None
    assert "card" in costs["temp_bytes_reason"]
    train = dryrun.run_case("mixtral-8x7b", "train_4k", True,
                            str(tmp_path), device="cpu")
    m = train["memory"]
    assert m["donated_bytes"] == m["params_bytes"] + m["optimizer_bytes"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.run_case("smollm-360m", "train_4k", False, str(tmp_path),
                            force=True)


_MATRIX = """
import json, os, sys, time
sys.modules["jax"] = None          # any import of jax or repro now fails
sys.modules["repro"] = None
from repro_torch.launch.dryrun import main
t0 = time.perf_counter()
try:
    main(["--all", "--both-meshes", "--device", "cpu", "--out", sys.argv[1]])
except SystemExit as e:
    code = e.code
recs = [json.load(open(os.path.join(sys.argv[1], f)))
        for f in sorted(os.listdir(sys.argv[1]))]
print(json.dumps({"code": code, "s": time.perf_counter() - t0,
                  "n": len(recs),
                  "ok": sum(r["status"] == "ok" for r in recs)}))
"""


def test_dryrun_matrix_runs_without_jax(tmp_path):
    """80 records (10 archs x 4 shapes x 2 meshes), all ok, in under a
    minute, in a process where jax and repro cannot be imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _MATRIX, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.splitlines()[-1])
    assert (res["code"], res["n"], res["ok"]) == (0, 80, 80)
    assert res["s"] < 60


@pytest.mark.parametrize("launcher,argv", [
    ("train", ["--arch", "mixtral-8x7b", "--dry-run"]),
    ("serve", ["--arch", "zamba2-7b", "--dry-run", "--shape",
               "decode_32k", "--multi-pod"])])
def test_launchers_write_a_dry_run_record(launcher, argv, tmp_path):
    from repro_torch.launch import serve, train
    main = {"train": train.main, "serve": serve.main}[launcher]
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    assert exc.value.code == 0
    (path,) = tmp_path.iterdir()
    shape = "train_4k" if launcher == "train" else "decode_32k"
    mesh = "pod2x16x16" if "--multi-pod" in argv else "pod16x16"
    assert path.name == f"{argv[1]}__{shape}__{mesh}.json"


# -- the plan placed on four gloo ranks ---------------------------------------

_RANK = r'''
import dataclasses, sys
from datetime import timedelta
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
torch.set_num_threads(1)
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, sharding as sh
from repro_torch.models.transformer import Model
try:
    M.device_mesh(M.make_test_mesh(1, 2), device="cpu")
    raise SystemExit("a 1 x 2 mesh over 4 ranks was not refused")
except ValueError as e:
    assert "needs 2 ranks" in str(e), e
spec = M.make_test_mesh(2, 2)
dm = M.device_mesh(spec, device="cpu")
coord = {"data": rank // 2, "model": rank % 2}
cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), scan_layers=True)
model = Model(cfg, device="cpu", seed=0)
n = 0
for mode in ("train", "serve"):
    specs = sh.params_shardings(model.tree(), cfg, spec, mode=mode)
    for path, t, s in sh.leaves_with_specs(model.tree(), specs):
        local = distribute_tensor(t.detach(), dm,
                                  sh.placements(s, spec)).to_local()
        assert tuple(local.shape) == sh.local_shape(t.shape, s, spec), path
        want = t.detach()
        for d, entry in enumerate(s):      # the slice JAX's layout holds
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                i, k = 0, 1
                for a in axes:
                    i, k = i * 2 + coord[a], k * 2
                step = want.shape[d] // k
                want = want.narrow(d, i * step, step)
        assert torch.equal(local, want), path
        n += any(e is not None for e in s)
print("sharded", n)
dist.destroy_process_group()
'''


def test_device_mesh_places_the_plan_on_four_ranks(tmp_path):
    """A 2 x 2 mesh of four gloo ranks: each leaf of a reduced zamba2
    (stacked as the JAX package stacks it, so its vectors shard over
    ``model``) distributed with the plan's placements holds, on every
    rank, the shard ``local_shape`` states, with the values of JAX's
    device layout (data outermost)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    deadline = time.monotonic() + 90
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail("four ranks did not finish in 90 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [(p.returncode, p.stdout.read(), p.stderr.read()) for p in procs]
    for r, (code, out, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-2000:]}"
    counts = {out.split()[-1] for _, out, _ in outs}
    assert len(counts) == 1 and int(counts.pop()) > 0
