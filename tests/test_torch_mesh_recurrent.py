"""The sharded LM step of the port for the recurrent families, rwkv6 and
the mamba2/zamba2 hybrid, on a 2 x 2 mesh of four gloo ranks on the CPU,
held against the single-device step under the same
``activation_sharding`` context (the single-device step is held against
the JAX package in ``test_torch_families.py``).

Reduced configs with ``scan_layers`` on, so that the plan splits them as
it splits the stacked leaves at full size (per-layer vectors over
``model``; zamba2's mamba blocks in (periods, period) stacks and a tail):
  * rwkv6, 4 heads of 32: the heads split over ``model``;
  * rwkv6, 3 heads of 32 (d 96): the heads cannot split, D's weights
    still do (48 channels a rank, half a head);
  * zamba2, 4 SSM heads, a shared attention block every 2 of 5 layers:
    two shared calls and a tail block.
rwkv6 trains at S 128 (two 64-token wkv chunks; below 64 the scan runs
chunks of 1), zamba2 at S 32 with ``ssm_chunk`` 16 (two SSD chunks).

Each case, in one spawn of four ranks: f32 train steps at B 4 (the batch
over ``('data','model')``) and B 2 (over ``('data',)``, heads and weights
over ``model``), the bf16 step with f32 masters (the ``param_specs``
pin), then prefill at B 4 and four decode steps fed the single-device
run's tokens.  Limits as ``test_torch_mesh_step.py``'s: ce and grad_norm
rtol 1e-5, every updated leaf within 1e-5 x max(1, max |w|) (2 x lr where
|g| < 1e-5), bf16 ce 5e-4, logits 1e-4 x max(1, max |logit|), greedy
tokens equal.  After prefill and after every decode step each state and
cache leaf has the placements of the plan (``sharding.cache_shardings``),
and no decode step all-gathers a state or cache shard (a gather whose
input is a rank's shard of a leaf, or a view of it: its storage; in
decode an activation (B, 1, D) flattened for a product has the shape of
an x_prev shard, so the shape alone cannot tell them apart).  The ranks are
spawned by ``test_torch_mesh_step._spawn`` (its limit, SPAWN_LIMIT_S,
240 s).
"""
import pytest

from test_torch_mesh_step import _spawn

CASES = ("rwkv6-7b", "rwkv6-7b-h3", "zamba2-7b")

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
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.models.transformer import Model
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_grad_fn, make_train_step)
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils.dist import dtensor_collectives, gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

CASES = {"rwkv6-7b": ("rwkv6-7b", {}, 128, 128),
         "rwkv6-7b-h3": ("rwkv6-7b", dict(d_model=96), 128, 128),
         "zamba2-7b": ("zamba2-7b", dict(shared_attn_period=2, n_layers=5),
                       32, 32)}
MAX_PAD, NEW = 8, 4
mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")


def config(name):
    arch, kw, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), scan_layers=True,
                               **kw)


def tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                         dtype=np.int64).astype(np.int32))


def err(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return float((a.float() - b.float()).abs().max())


def train(cfg, b, s, dtype):
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    batch = {"tokens": tokens(cfg, b, s, b)}
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


def placed(cache, c_specs):
    """Paths of the state and cache leaves not in the plan's placements."""
    return [p for p, leaf, s in sh.leaves_with_specs(cache["blocks"],
                                                      c_specs)
            if tuple(leaf.placements) != tuple(sh.placements(s, mesh))]


def serve(cfg, b, prompt_len):
    dt = torch.float32
    prompt = {"tokens": tokens(cfg, b, prompt_len, 7)}
    max_len = prompt_len + MAX_PAD
    axes = sh.pick_batch_axes(mesh, b, allow_model=False)
    ref = Model(cfg, device="cpu", seed=0)
    with activation_sharding(mesh, axes):
        c1 = ref.init_cache(b, max_len, dtype=dt)
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
    cache = model.init_cache(b, max_len, dtype=dt)
    c_sh = sh.cache_shardings(cache, cfg, mesh)
    cache = sh.distribute(cache, c_sh, mesh, dm)
    c_specs = c_sh["blocks"]
    plan = {p: sh.placements(s, mesh)
            for p, _, s in sh.leaves_with_specs(cache["blocks"], c_specs)}
    dprompt = sh.distribute(prompt, sh.batch_shardings(prompt, mesh, axes),
                            mesh, dm)
    got, gathers, counts, misplaced = [], [], [], []
    with activation_sharding(mesh, axes, dm):
        l2, cache = pre["fn"](params, dprompt, cache)
        got.append(l2)
        misplaced.append(placed(cache, c_specs))
        for t in fed:
            held = {leaf.to_local().untyped_storage().data_ptr()
                    for _, leaf, _ in sh.leaves_with_specs(cache["blocks"],
                                                           c_specs)}
            with dtensor_collectives() as (mode, calls):
                l2, cache = dec["fn"](params, t, cache)
            gathers += [(c.name, list(c.shape)) for c in calls
                        if "gather" in c.name and c.storage in held]
            counts.append(len(calls))
            got.append(l2)
            misplaced.append(placed(cache, c_specs))
    errs = [err(g, w) / max(1.0, float(w.abs().max()))
            for g, w in zip(got, want)]
    same = [bool(torch.equal(g.full_tensor().argmax(-1), w.argmax(-1)))
            for g, w in zip(got, want)]
    split = sorted({p.rsplit("/", 1)[1] for p, pl in plan.items()
                    if any(q.is_shard() for q in pl[1:])})
    return dict(logit_err=errs, tokens_equal=same, misplaced=misplaced,
                model_split=split, decode_collectives=counts,
                state_gathers=gathers, batch_axes=list(axes))


results = {}
with gloo_collectives():
    for name in sys.argv[4].split(","):
        cfg = config(name)
        _, _, s, prompt_len = CASES[name]
        results[name] = dict(
            train_b4=train(cfg, 4, s, torch.float32),
            train_b2=train(cfg, 2, s, torch.float32),
            train_bf16=train(cfg, 4, s, torch.bfloat16),
            serve=serve(cfg, 4, prompt_len))
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh_recurrent"), CASES, _RANK)


@pytest.mark.parametrize("batch", ["train_b4", "train_b2"])
@pytest.mark.parametrize("case", CASES)
def test_train_step_f32_matches_one_device(runs, case, batch):
    r = runs[case][batch]
    assert r["batch_axes"] == (["data", "model"] if batch == "train_b4"
                               else ["data"])
    for k in ("ce", "grad_norm"):
        one, mesh = r[k]
        assert abs(mesh - one) <= 1e-5 * abs(one), (k, one, mesh)
    assert r["leaf_err"] <= 1e-5
    assert r["steep_err"] <= 2 * r["lr"]
    assert r["collectives"] > 0


@pytest.mark.parametrize("case", CASES)
def test_train_step_bf16_pins_casts_to_masters(runs, case):
    r = runs[case]["train_bf16"]
    assert r["pinned"] and r["cast_leaves"] > 0
    one, mesh = r["ce"]
    assert abs(mesh - one) <= 5e-4 * abs(one)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_one_device(runs, case):
    r = runs[case]["serve"]
    assert r["batch_axes"] == ["data"]
    assert len(r["logit_err"]) == 5
    assert max(r["logit_err"]) <= 1e-4
    assert all(r["tokens_equal"])


@pytest.mark.parametrize("case", CASES)
def test_states_keep_the_plans_placements(runs, case):
    """After prefill and every decode step; the plan splits rwkv's S over
    heads only where they divide, its x_prev over D, mamba's ssm over
    heads and the shared caches over T (the conv window: batch only)."""
    r = runs[case]["serve"]
    assert r["misplaced"] == [[]] * 5
    want = {"rwkv6-7b": ["S", "x_prev_cm", "x_prev_tm"],
            "rwkv6-7b-h3": ["x_prev_cm", "x_prev_tm"],
            "zamba2-7b": ["k", "pos", "ssm", "v"]}[case]
    assert r["model_split"] == want


@pytest.mark.parametrize("case", CASES)
def test_decode_never_gathers_a_state(runs, case):
    r = runs[case]["serve"]
    assert r["state_gathers"] == []
    assert len(r["decode_collectives"]) == 4
    assert min(r["decode_collectives"]) > 0
