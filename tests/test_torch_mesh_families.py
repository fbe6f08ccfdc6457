"""The sharded LM step of the port for the attention-block families past
the dense one (MoE, vlm, audio) and the window's ring, on a 2 x 2 mesh of
four gloo ranks on the CPU, held against the single-device step under the
same ``activation_sharding`` context (no device mesh: MoE then routes in
as many groups on one device as on the mesh; the single-device step is
held against the JAX package in ``test_torch_families.py`` and, with
groups, ``test_torch_moe_groups.py``).

Reduced archs, with heads chosen so that each case of the ``model`` split
occurs (as ``test_torch_mesh_step.py`` picks them for the dense family):
  * granite-moe, 8 experts top-2, heads 4 / 2 (both split), d_ff 64 < d
    128: the plan splits the experts' D over ``model`` and F over
    ``data``;
  * mixtral, 4 experts, heads 6 / 3 (q heads split, kv heads not), F over
    ``model`` and D over ``data``; window 8 and max length 16: a ring of 8
    slots, 4 a rank, filled by an 8-token prompt and wrapped by the 4
    decode steps;
  * gemma's long_500k variant (``resolve_arch_for_shape``: window 4096),
    heads 4 / 1 (the one kv head on both ranks);
  * llava, heads 3 / 1 (q heads whole on every rank), a 4-embed image
    prefix (the decode steps' prefix is empty);
  * musicgen, heads 4 / 4, 4 codebooks (summed lookups, the (B, S, 4, V)
    head).

Each arch, in one spawn of four ranks: f32 train steps at B 4 (batch over
``('data','model')``, MoE in 4 groups) and B 2 (over ``('data',)``, 2
groups), the bf16 step with f32 masters (the ``param_specs`` pin), and
prefill at B 4 (2 groups) then four decode steps (4 tokens: fewer a group
than experts, one group), fed the single-device run's tokens.  Limits as
``test_torch_mesh_step.py``'s: ce and grad_norm rtol 1e-5, every updated
leaf within 1e-5 x max(1, max |w|) (2 x lr where |g| < 1e-5), bf16 ce
5e-4, logits 1e-4 x max(1, max |logit|), greedy tokens equal, no decode
step all-gathers a cache shard (a gather whose input has a rank's k or v
cache shard's dims, in any order).  The ranks are spawned by
``test_torch_mesh_step._spawn`` (its limit, SPAWN_LIMIT_S, 240 s).
"""
import pytest

from test_torch_mesh_step import _spawn

ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b", "gemma-2b",
         "llava-next-mistral-7b", "musicgen-medium")

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
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.models.transformer import Model
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_grad_fn, make_train_step)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils.dist import dtensor_collectives, gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

SHAPE = {"granite-moe-1b-a400m": ("train_4k", dict(
             n_heads=4, n_kv_heads=2, n_experts=8, d_ff=64)),
         "mixtral-8x7b": ("train_4k", dict(n_heads=6, n_kv_heads=3,
                                           sliding_window=8)),
         "gemma-2b": ("long_500k", dict(n_heads=4, n_kv_heads=1)),
         "llava-next-mistral-7b": ("train_4k", dict(
             n_heads=3, n_kv_heads=1, frontend_tokens=4)),
         "musicgen-medium": ("train_4k", dict(n_heads=4, n_kv_heads=4))}
SEQ, MAX_LEN, NEW = 8, 16, 4
mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")


def config(arch):
    shape, kw = SHAPE[arch]
    cfg, _ = specs.resolve_arch_for_shape(arch, shape)
    window = cfg.sliding_window
    cfg = dataclasses.replace(cfg.reduced(), head_dim=32, **kw)
    if "sliding_window" not in kw and window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return cfg


def batch_of(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.family == "audio" else (b, s)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape, dtype=np.int64).astype(np.int32))}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return out


def err(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return float((a.float() - b.float()).abs().max())


def train(cfg, b, dtype):
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    batch = batch_of(cfg, b, SEQ, b)
    axes = sh.pick_batch_axes(mesh, b, allow_model=True)
    ref = Model(cfg, device="cpu", seed=0)
    p1, o1 = init_train_state(ref, tc)
    with activation_sharding(mesh, axes):
        g1, _ = make_grad_fn(ref, tc)(p1, batch)
        p1, o1, m1 = make_train_step(ref, tc)(p1, o1, batch)

    case = specs.build_case_from_cfg(cfg, "train_4k", mesh,
                                     compute_dtype=dtype)
    p_sh, o_sh = case["in_specs"][:2]
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
            params, opt, m2 = case["fn"](params, opt, dbatch)
    finally:
        Model.forward = forward
    res = dict(batch_axes=list(axes),
               ce=[float(m1["ce"]), float(m2["ce"])],
               grad_norm=[float(m1["grad_norm"]), float(m2["grad_norm"])])
    if cfg.is_moe:
        res["drop"] = [float(m1["moe_drop_frac"]),
                       float(m2["moe_drop_frac"])]
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
    prompt = batch_of(cfg, b, SEQ if cfg.sliding_window == SEQ else 6, 7)
    axes = sh.pick_batch_axes(mesh, b, allow_model=False)
    ref = Model(cfg, device="cpu", seed=0)
    with activation_sharding(mesh, axes):
        c1 = ref.init_cache(b, MAX_LEN, dtype=dt)
        l1, c1 = ref.prefill(prompt, c1, dt)
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
    dprompt = sh.distribute(prompt, sh.batch_shardings(prompt, mesh, axes),
                            mesh, dm)
    got, decode_calls = [], []
    k0 = cache["blocks"][0]["k"]
    t_split = isinstance(k0.placements[1], Shard)
    with activation_sharding(mesh, axes, dm):
        l2, cache = pre["fn"](params, dprompt, cache)
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
    shard = sorted(k0.to_local().shape)
    big = [c for calls in decode_calls for c in calls
           if "gather" in c[0] and sorted(c[1]) == shard]
    return dict(logit_err=errs, tokens_equal=same, t_split=t_split,
                ring=[int(k0.shape[1]), int(k0.to_local().shape[1])],
                prompt=int(prompt["tokens"].shape[1]),
                decode_collectives=[len(c) for c in decode_calls],
                cache_gathers=big, batch_axes=list(axes))


results = {}
with gloo_collectives():
    for arch in sys.argv[4].split(","):
        cfg = config(arch)
        results[arch] = dict(
            window=cfg.sliding_window,
            train_b4=train(cfg, 4, torch.float32),
            train_b2=train(cfg, 2, torch.float32),
            train_bf16=train(cfg, 4, torch.bfloat16),
            serve=serve(cfg, 4))
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh_families"), ARCHS, _RANK)


@pytest.mark.parametrize("batch", ["train_b4", "train_b2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_f32_matches_one_device(runs, arch, batch):
    r = runs[arch][batch]
    assert r["batch_axes"] == (["data", "model"] if batch == "train_b4"
                               else ["data"])
    for k in ("ce", "grad_norm"):
        one, mesh = r[k]
        assert abs(mesh - one) <= 1e-5 * abs(one), (k, one, mesh)
    if "drop" in r:
        assert r["drop"][0] == r["drop"][1]
    assert r["leaf_err"] <= 1e-5
    assert r["steep_err"] <= 2 * r["lr"]


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


def test_the_ring_wraps_on_a_sequence_sharded_cache(runs):
    """mixtral's ring: 8 slots, 4 a rank; the prompt fills it and the
    decode steps (positions 8-11) overwrite rank 0's slots."""
    r = runs["mixtral-8x7b"]
    assert r["window"] == 8
    assert r["serve"]["ring"] == [8, 4] and r["serve"]["prompt"] == 8
    assert runs["gemma-2b"]["window"] == 4096


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_never_gathers_the_cache(runs, arch):
    r = runs[arch]["serve"]
    assert r["cache_gathers"] == []
    assert len(r["decode_collectives"]) == 4
    assert min(r["decode_collectives"]) > 0
