"""The sharded LM step of the port on a 2 x 2 mesh of four gloo ranks, on
the CPU, held against the single-device step (the JAX package never runs
the LM on a mesh; the single-device step is held against it in
``test_torch_lm.py`` and ``test_torch_train.py``).

The four dense archs, reduced, with heads chosen to cover each case of the
``model`` split: smollm 3 / 1 (q heads do not divide 2: whole on every
rank), gemma 4 / 1 (q heads split, the one kv head on both ranks), granite
4 / 2 (both split), starcoder2 6 / 3 (q heads split, kv heads not: rank 0's
heads 0-2 read kv heads 0, 0, 1, so the rank takes one kv head per query
head).  granite and starcoder2 keep the plan's stacked layout
(``scan_layers``), so their norm vectors shard over ``model`` too;
granite's vocabulary is odd (511; 49,155 at full width), so its tied
embedding splits D over ``model`` rather than the vocabulary.

Each arch, in one spawn of four ranks:
  * f32 train steps at B 4 (the batch over ``('data','model')``) and B 2
    (over ``('data',)``, the weights over ``model``), each from the same
    weights as the single-device step: ce and grad_norm within rtol 1e-5,
    every updated leaf (``full_tensor()``) within 1e-5 x max(1, max |w|),
    or 2 x lr where the gradient nears AdamW's eps (|g| < 1e-5);
  * a bf16 step with f32 masters: every leaf the forward reads has its
    master's placements (the ``param_specs`` pin), ce within 5e-4;
  * prefill of 6 tokens into a 16-slot cache (T 8 a rank), then four
    decode steps fed the single-device run's tokens: logits within 1e-4 x
    max(1, max |logit|), greedy tokens equal; the first two decode steps
    leave rank 1's slice with no live slot.  No decode step all-gathers a
    cache-sized tensor (DTensor's collectives recorded by
    ``utils.dist.dtensor_collectives``).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_test_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-360m", "gemma-2b", "granite-3-2b", "starcoder2-15b")
SPAWN_LIMIT_S = 240

_RANK = r'''
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
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_grad_fn, make_train_step)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils.dist import dtensor_collectives, gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

HEADS = {"smollm-360m": (3, 1, False, 512), "gemma-2b": (4, 1, False, 512),
         "granite-3-2b": (4, 2, True, 511), "starcoder2-15b": (6, 3, True, 512)}
SEQ, PROMPT, MAX_LEN, NEW = 8, 6, 16, 4
mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")


def config(arch):
    h, kv, stacked, vocab = HEADS[arch]
    return dataclasses.replace(get_config(arch).reduced(), n_heads=h,
                               n_kv_heads=kv, head_dim=32,
                               scan_layers=stacked, vocab_size=vocab)


def tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                         dtype=np.int64).astype(np.int32))


def err(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return float((a.float() - b.float()).abs().max())


def train(cfg, b, dtype):
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    batch = {"tokens": tokens(cfg, b, SEQ, b)}
    ref = Model(cfg, device="cpu", seed=0)
    p1, o1 = init_train_state(ref, tc)
    g1, _ = make_grad_fn(ref, tc)(p1, batch)
    p1, o1, m1 = make_train_step(ref, tc)(p1, o1, batch)

    case = specs.build_case_from_cfg(cfg, "train_4k", mesh,
                                     compute_dtype=dtype)
    p_sh, o_sh = case["in_specs"][:2]
    axes = sh.pick_batch_axes(mesh, b, allow_model=True)
    model = Model(cfg, device="cpu", seed=0)
    _, opt = init_train_state(model, tc)
    model.load_tree(sh.distribute(model.tree(), p_sh, mesh, dm))
    params = model.tree()
    opt = sh.distribute(opt, o_sh, mesh, dm)
    dbatch = sh.distribute(batch, sh.batch_shardings(batch, mesh, axes),
                           mesh, dm)
    read = []
    forward = Model.forward
    Model.forward = lambda self, W, *a, **k: (read.append(W),
                                              forward(self, W, *a, **k))[1]
    try:
        with activation_sharding(mesh, axes, dm):
            with dtensor_collectives() as (mode, calls):
                params, opt, m2 = case["fn"](params, opt, dbatch)
    finally:
        Model.forward = forward
    res = dict(batch_axes=list(axes), collectives=len(calls),
               ce=[float(m1["ce"]), float(m2["ce"])],
               grad_norm=[float(m1["grad_norm"]), float(m2["grad_norm"])])
    if dtype == torch.float32:
        worst, steep = 0.0, 0.0
        for a, w, g in zip(tree_leaves(params), tree_leaves(p1),
                           tree_leaves(g1)):
            d = (a.full_tensor() - w).detach().abs()
            flat = g.abs() < 1e-5
            scale = max(1.0, float(w.detach().abs().max()))
            worst = max(worst, float(torch.where(flat, 0, d).max()) / scale)
            steep = max(steep, float(torch.where(flat, d, 0).max()))
        res.update(leaf_err=worst, steep_err=steep, lr=tc.lr)
    else:
        masters = tree_leaves(opt.master)
        res["pinned"] = all(
            tuple(w.placements) == tuple(m.placements)
            for w, m in zip(tree_leaves(read[0]), masters)
            if w.dim() >= 2)
        res["cast_leaves"] = sum(w.dtype == dtype
                                 for w in tree_leaves(read[0]))
    return res


def serve(cfg, b):
    dt = torch.float32
    prompt = tokens(cfg, b, PROMPT, 7)
    ref = Model(cfg, device="cpu", seed=0)
    c1 = ref.init_cache(b, MAX_LEN, dtype=dt)
    l1, c1 = ref.prefill({"tokens": prompt}, c1, dt)
    want, fed = [l1], []
    for _ in range(NEW):
        fed.append(want[-1].argmax(-1).to(torch.int32))
        l1, c1 = ref.decode_step(fed[-1], c1, dt)
        want.append(l1)

    pre = specs.build_case_from_cfg(cfg, "prefill_32k", mesh,
                                    compute_dtype=dt)
    dec = specs.build_case_from_cfg(cfg, "decode_32k", mesh,
                                    compute_dtype=dt)
    model = Model(cfg, device="cpu", seed=0)
    p_sh = sh.params_shardings(model.tree(), cfg, mesh, mode="serve")
    model.load_tree(sh.distribute(model.tree(), p_sh, mesh, dm))
    params = model.weights(dt)
    cache = model.init_cache(b, MAX_LEN, dtype=dt)
    cache = sh.distribute(cache, sh.cache_shardings(cache, cfg, mesh),
                          mesh, dm)
    axes = sh.pick_batch_axes(mesh, b, allow_model=False)
    got, decode_calls = [], []
    t_split = isinstance(cache["blocks"][0]["k"].placements[1], Shard)
    with activation_sharding(mesh, axes, dm):
        l2, cache = pre["fn"](params, {"tokens": prompt}, cache)
        got.append(l2)
        for t in fed:
            with dtensor_collectives() as (mode, calls):
                l2, cache = dec["fn"](params, t, cache)
            decode_calls.append([(c.name, list(c.shape)) for c in calls])
            got.append(l2)
    errs = [err(g, w) / max(1.0, float(w.abs().max()))
            for g, w in zip(got, want)]
    same = [bool(torch.equal(g.full_tensor().argmax(-1), w.argmax(-1)))
            for g, w in zip(got, want)]
    shard = np.prod(cache["blocks"][0]["k"].to_local().shape)
    big = [c for calls in decode_calls for c in calls
           if "gather" in c[0] and np.prod(c[1]) == shard]
    return dict(logit_err=errs, tokens_equal=same, t_split=t_split,
                decode_collectives=[len(c) for c in decode_calls],
                cache_gathers=big, batch_axes=list(axes))


results = {}
with gloo_collectives():
    for arch in sys.argv[4].split(","):
        cfg = config(arch)
        results[arch] = dict(
            train_b4=train(cfg, 4, torch.float32),
            train_b2=train(cfg, 2, torch.float32),
            train_bf16=train(cfg, 4, torch.bfloat16),
            serve=serve(cfg, 4))
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


def _spawn(tmp_path, archs, script=_RANK):
    """``script`` on four gloo ranks (argv: rank, store, results file,
    archs); rank 0's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = tmp_path / "results.json"
    logs = [open(tmp_path / f"log.{r}", "w+") for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", "-c", script, str(r),
         str(tmp_path / "store"),
         str(out), ",".join(archs)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"four ranks did not finish in {SPAWN_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r}: {text[-3000:]}"
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh"), ARCHS)


@pytest.mark.parametrize("batch", ["train_b4", "train_b2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_f32_matches_one_device(runs, arch, batch):
    r = runs[arch][batch]
    assert r["batch_axes"] == (["data", "model"] if batch == "train_b4"
                               else ["data"])
    for k in ("ce", "grad_norm"):
        one, mesh = r[k]
        assert abs(mesh - one) <= 1e-5 * abs(one), (k, one, mesh)
    assert r["leaf_err"] <= 1e-5
    assert r["steep_err"] <= 2 * r["lr"]
    assert r["collectives"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bf16_pins_casts_to_masters(runs, arch):
    r = runs[arch]["train_bf16"]
    assert r["pinned"] and r["cast_leaves"] > 0
    one, mesh = r["ce"]
    assert abs(mesh - one) <= 5e-4 * abs(one)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_device(runs, arch):
    r = runs[arch]["serve"]
    assert r["batch_axes"] == ["data"] and r["t_split"]
    assert len(r["logit_err"]) == 5
    assert max(r["logit_err"]) <= 1e-4
    assert all(r["tokens_equal"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_never_gathers_the_cache(runs, arch):
    r = runs[arch]["serve"]
    assert r["cache_gathers"] == []
    assert len(r["decode_collectives"]) == 4
    assert min(r["decode_collectives"]) > 0


#: every arch's train and decode step, and the window variant's decode
STEPS = tuple((arch, shape) for arch in ALL_ARCHS
              for shape in ("train_4k", "decode_32k")) + (
    ("smollm-360m", "long_500k"),)

_STEPS = r'''
import dataclasses, json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.models.transformer import Model
from repro_torch.train.loop import TrainConfig, init_train_state
from repro_torch.utils.pjit_utils import activation_sharding

mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")
B, S, MAX_LEN = 4, 8, 16


def run(arch, shape):
    full, variant = specs.resolve_arch_for_shape(arch, shape)
    cfg = dataclasses.replace(full.reduced(), scan_layers=True)
    case = specs.build_case_from_cfg(cfg, shape, mesh, torch.float32,
                                     variant=variant)
    model = Model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    frames = (cfg.n_codebooks,) if cfg.family == "audio" else ()

    def place(tree, specs_):
        return sh.distribute(tree, specs_, mesh, dm)

    with activation_sharding(mesh, case["batch_axes"], dm):
        if case["kind"] == "train":
            tc = TrainConfig()
            _, opt = init_train_state(model, tc)
            p_sh, o_sh = case["in_specs"][:2]
            model.load_tree(place(model.tree(), p_sh))
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S) + frames)).int()}
            if cfg.family == "vlm":
                batch["image_embeds"] = torch.randn(
                    B, cfg.frontend_tokens, cfg.d_model)
            batch = place(batch, sh.batch_shardings(batch, mesh,
                                                    case["batch_axes"]))
            _, _, metrics = case["fn"](model.tree(), place(
                opt, o_sh), batch)
            return dict(kind="train", window=cfg.sliding_window,
                        finite=bool(torch.isfinite(metrics["ce"])))
        model.load_tree(place(model.tree(), case["in_specs"][0]))
        cache = model.init_cache(B, MAX_LEN, dtype=torch.float32)
        cache = place(cache, sh.cache_shardings(cache, cfg, mesh))
        tok = {"t": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B,) + frames)).int()}
        tok = place(tok, sh.batch_shardings(tok, mesh,
                                            case["batch_axes"]))["t"]
        logits, cache = case["fn"](model.weights(torch.float32), tok, cache)
        logits = logits.full_tensor()
        return dict(kind=case["kind"], window=cfg.sliding_window,
                    finite=bool(torch.isfinite(logits).all()),
                    shape=list(logits.shape),
                    want=[B, *frames, cfg.vocab_size],
                    pos=cache["pos"].full_tensor().tolist())


results = {}
for step in sys.argv[4].split(","):
    results[step] = run(*step.split("/"))
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("steps"),
                  [f"{a}/{s}" for a, s in STEPS], _STEPS)


@pytest.mark.parametrize("arch,shape", STEPS)
def test_build_case_fn_runs_for_every_family(steps_run, arch, shape):
    """``build_case``'s step for every family and the window variant: the
    full-size case gives a step of its shape's kind, and the same case at
    reduced widths runs it on DTensors on four gloo ranks (B 4): finite
    ce, or logits of (B, [codebooks,] V) with each row's position
    advanced."""
    case = specs.build_case(arch, shape, make_test_mesh(2, 2))
    assert callable(case["fn"]) and case["kind"] == get_shape(shape).kind
    r = steps_run[f"{arch}/{shape}"]
    assert r["kind"] == case["kind"] and r["finite"]
    if r["kind"] == "decode":
        assert r["shape"] == r["want"] and r["pos"] == [1] * 4
    if shape == "long_500k":
        assert case["cfg"].sliding_window == 4096 and r["window"] == 64


def test_distribute_raises_on_a_leaf_without_a_spec():
    """``sharding.distribute`` places nothing it has no spec for."""
    import torch
    from repro_torch.launch import sharding as sh
    mesh = make_test_mesh(2, 2)
    tree = {"a": torch.zeros(4, 2), "b": [torch.zeros(2)]}
    for specs in ({"a": (None, None)}, {"a": (None,), "b": [(None,)]},
                  {"a": (None, None), "b": []}):
        with pytest.raises(ValueError, match="spec"):
            sh.distribute(tree, specs, mesh, None)
