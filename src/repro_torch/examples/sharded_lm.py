"""The sharded LM step: ``launch.specs.build_case``'s train, prefill and
decode steps on a 2 x 2 ``DeviceMesh`` (axes ``data`` x ``model``), every
rank one process running the whole script (SPMD).

    # four cards, one NCCL rank each
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        --master_addr localhost -m repro_torch.examples.sharded_lm
    # four gloo ranks on the CPU, reduced configs
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        --master_addr localhost -m repro_torch.examples.sharded_lm \
        --device cpu --local

The LM counterpart of ``examples/sharded.py``.  Rank 0 first runs every
run on its own device, without a device mesh but inside the same
``activation_sharding`` context (so that MoE routes in as many groups),
and hands the ranks what the mesh runs replay of it: the decode steps'
tokens and MoE's expert choices.  Then every rank runs the same runs on
the mesh, with parameters, optimizer state, batch and cache placed by the
plan (``launch.sharding``), and rank 0 holds them against the one-device
runs (``TRAIN_RTOL``, ``LOGIT_TOL``: PERF.md §2's mesh-step limits, but
for ``FLOOR_ARCHS``' rows whose own rounding floor, measured by rank 0 in
the same call, is above them: those are held to ``FLOOR_FACTOR`` x the
floor, ``held_limit``) and prints one JSON line: per run its errors, the
limit that held it, walls, peak GiB a rank and DTensor's collectives a
step by kind, and the flash, decode and cache attention launches over the
ranks.  ``SEGMENTED`` runs prefill their prompt in several calls on one
cache (the later ones through the cache attention kernel).  Two faults
(``PLANTS``) planted in rwkv6's f32 generate state after its prefill must
each miss the limit that holds that row.  ``MESH_ONLY`` runs have no
one-device reference, since no card holds one: their ce is finite and
equal on every rank, and each rank's parameter and optimizer bytes are
the plan's (``plan_state_bytes``).  ``examples.sharded_lm_floor`` holds a run's
error against the one-device run's own rounding floor.

A rank raises at once where one of its cache or state leaves leaves the
plan's placements, or where a decode step all-gathers one of its shards;
the launcher then stops the other ranks and exits non-zero.  A rank left
waiting in a collective gives up after ``TIMEOUT_S``, the group's
timeout.  On NCCL, DTensor's functional collectives run as they are; on a
gloo group (the CPU, or ranks sharing a card) they go through
``utils.dist.gloo_collectives``.

``mesh_train_run`` and ``mesh_generate_run`` are the runs themselves, on
any device and mesh (one device where ``dm`` is None).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from datetime import timedelta

import numpy as np
import torch

from repro_torch.utils.timing import tick

F32, BF16 = torch.float32, torch.bfloat16
#: a train step's sequence length, the steps of a train run, and the
#: tokens a generate yields (its prefill's, then NEW - 1 decode steps')
SEQ, STEPS, NEW = 512, 2, 8
#: mesh against one device: ce and grad_norm relative (bf16: ce only, the
#: train contract's); logits relative to max(1, max |logit|)
TRAIN_RTOL = {F32: 1e-5, BF16: 5e-4}
LOGIT_TOL = {F32: 1e-4, BF16: 5e-2}
#: how long a rank waits in a collective for the others, s
TIMEOUT_S = 600
#: (arch, layers (None: all), dtype, batch): STEPS AdamW steps each at
#: B x SEQ.  B 4 puts the batch over ('data', 'model'), B 2 over
#: ('data',) with the weights over 'model'.  rwkv6-7b and zamba2-7b train
#: at the deepest depth whose one-device step fits a card with 7 GiB to
#: spare for the allocator: the step's peak is about 20 B a parameter
#: (the bf16 weights and gradients, the f32 masters, moments and clipped
#: gradients), 10 x the plan's bf16 weight bytes (``plan_state_bytes``'
#: params part), + 1-3 GiB: rwkv6-7b at 14 layers (6.74 GiB of weights;
#: 16 layers 7.56), zamba2-7b at 36, six periods of six blocks (6.33; 42
#: layers 7.25).  On an H100 80GB their one-device peaks read 70.45 and
#: 65.16 GiB (PERF.md §6)
TRAIN = (("smollm-360m", None, BF16, 4), ("smollm-360m", None, F32, 2),
         ("granite-moe-1b-a400m", None, BF16, 4),
         ("rwkv6-7b", 14, BF16, 4), ("zamba2-7b", 36, BF16, 2))
#: (arch, layers, batch, prompt, dtypes): one generate each
GEN = (("smollm-360m", None, 8, 1024, (F32, BF16)),
       ("granite-moe-1b-a400m", None, 2, 256, (F32, BF16)),
       ("rwkv6-7b", None, 2, 256, (F32, BF16)),
       ("zamba2-7b", None, 2, 256, (F32, BF16)))
#: (arch, layers, batch, prompt, segments, dtypes): a generate whose
#: prompt is prefilled in ``segments`` equal calls on one cache (each after
#: the first continues it), then decode steps
SEGMENTED = (("smollm-360m", None, 8, 1024, 4, (F32, BF16)),)
#: train runs on the mesh alone (no card holds their one-device step)
MESH_ONLY = (("rwkv6-7b", None, BF16, 4),)
#: archs whose rows are held to their own rounding floor where it is above
#: the limits above: random-weight rwkv6-7b amplifies a perturbation of
#: float32's rounding past them at depth (PERF.md §2, §6).  The floor of a
#: row is the one-device run against itself with every weight scaled by
#: (1 + sharded_lm_floor.PERTURB x N(0, 1)), the largest error over
#: FLOOR_SEEDS, measured in the same call; where it is above the row's
#: limit the row is held to FLOOR_FACTOR x it (the mesh within 3 x the
#: largest seed's floor: the probe's prediction, written before the probe
#: first measured, PERF.md §6)
FLOOR_ARCHS = ("rwkv6-7b",)
FLOOR_SEEDS = (1, 2, 3)
FLOOR_FACTOR = 3.0
#: ``--local``'s sizes, for the reduced configs (``local_cfg``)
LOCAL = dict(seq=128, prompt=16, new=4)


def gen_runs(gens):
    """GEN's entries one (arch, layers, batch, prompt, dtype) a run."""
    return [(arch, depth, b, prompt, dtype)
            for arch, depth, b, prompt, dtypes in gens for dtype in dtypes]


def held_limit(limit, floor):
    """(the limit a row is held to, which one): ``limit`` (PERF.md §2's),
    unless it is under the row's ``floor`` (None where the row has none);
    then FLOOR_FACTOR x the floor."""
    if floor is None or floor <= limit:
        return limit, "PERF.md §2"
    return FLOOR_FACTOR * floor, f"{FLOOR_FACTOR:g} x floor"


def _scale_wkv(cache):
    """Rank 1's shard of every layer's wkv state scaled by 1 + 1e-3."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        for state in cache["blocks"]:
            state["S"].to_local().mul_(1 + 1e-3)


def _zero_x_prev(cache):
    """Rank 1's shard of every layer's token-shift x_prev (the time mix's)
    zeroed."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        for state in cache["blocks"]:
            state["x_prev_tm"].to_local().zero_()


#: faults planted in an rwkv6 f32 generate's state after its prefill on
#: the mesh: each must miss the limit that holds the row
PLANTS = {"wkv state x (1 + 1e-3) on rank 1": _scale_wkv,
          "token-shift x_prev zeroed on rank 1": _zero_x_prev}


def mesh_cfg(arch, depth=None):
    """``arch``'s published config, at ``depth`` layers (None: all)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def local_cfg(arch):
    """``arch`` reduced, its layers stacked as at full size
    (``scan_layers``); zamba2 with a shared block every 2 of 5 layers (two
    calls and a tail block)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), scan_layers=True)
    if cfg.shared_attn_period:
        cfg = dataclasses.replace(cfg, shared_attn_period=2, n_layers=5)
    return cfg


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    """The allocator's peak GiB since the reset; None on the CPU (not
    measured)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def through_gloo(dev) -> bool:
    """Whether the default process group carries ``dev``'s tensors through
    gloo (the CPU, or ranks sharing a card) rather than NCCL."""
    import torch.distributed as dist
    config = dist.get_backend_config()
    backends = dict(p.split(":") for p in config.split(","))
    if dev.type not in backends:
        raise RuntimeError(f"the process group ({config!r}) carries no "
                           f"{dev.type} tensors")
    return backends[dev.type] == "gloo"


def collectives_for(dev):
    """``utils.dist.gloo_collectives()`` where the group carries ``dev``'s
    tensors through gloo; nothing on NCCL, whose functional collectives
    DTensor calls as they are."""
    from repro_torch.utils import dist as dist_utils
    if through_gloo(dev):
        return dist_utils.gloo_collectives()
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def mesh_batch(cfg, b, s, seed, dev):
    """A batch from ``seed``: tokens (B, S) (audio: (B, S, C)); vlm also its
    ``frontend_tokens`` image embeddings (B, P, D)."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.family == "audio" else (b, s)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).to(dev, torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    return batch


def _mesh_model(cfg, dev, mesh=None, dm=None, mode="train", tc=None):
    """``cfg`` from seed 0 on ``dev`` (and, with ``tc``, its optimizer
    state); on a mesh its parameters placed by the plan (``mode``) before
    the optimizer's state is made, so that no rank holds a whole model's
    optimizer state.  Ranks whose group goes
    through gloo build one after another, so that only one holds a whole
    model at a time (they may share a card); on NCCL each builds on its
    own card at once."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.train.loop import (init_train_state, make_optimizer,
                                        make_trainable)
    if dm is None:
        model = build_model(cfg, device=dev, seed=0)
        state = init_train_state(model, tc)[1] if tc else None
        return model, state
    model = state = None
    serial = through_gloo(dev)
    for r in range(dist.get_world_size() if serial else 1):
        if not serial or r == dist.get_rank():
            model = build_model(cfg, device=dev, seed=0)
            if tc:
                make_trainable(model, tc)
            specs = sh.params_shardings(model.tree(), cfg, mesh, mode=mode)
            model.load_tree(sh.distribute(model.tree(), specs, mesh, dm))
            state = make_optimizer(tc).init(model.tree()) if tc else None
            _free(dev)
        if serial:
            dist.barrier()
    return model, state


def _group_slice(dm, axes, groups, local):
    """The slice of a call's ``groups`` routing groups that this rank holds
    ``local`` of: its index over the batch axes, outermost first."""
    if groups == local:
        return slice(None)
    coord, names = dm.get_coordinate(), dm.mesh_dim_names
    r = 0
    for a in axes:
        i = names.index(a)
        r = r * dm.size(i) + coord[i]
    return slice(r * local, (r + 1) * local)


def routing_flips(a, b):
    """Tokens (in all layers and calls) whose expert sets differ."""
    return sum(int((torch.sort(x, -1)[0] != torch.sort(y, -1)[0]).any(
        -1).sum()) for x, y in zip(a, b))


@contextlib.contextmanager
def moe_routing(record=None, replay=None):
    """``models.moe.top_k`` (the router's expert choice) appending each
    call's experts to ``record``, or returning, call by call, the experts
    in ``replay`` with this route's own probabilities for them.  For a
    comparison of two routes only: bf16 rounds the router's logits, so a
    near-tie between two experts can fall either way on the two routes,
    and a token sent to another expert is another function, not a rounding
    error."""
    from repro_torch.models import moe
    saved = moe.top_k
    choices = None if replay is None else iter(replay)

    def top_k(probs, k):
        if choices is not None:
            idx = next(choices)
            return probs.gather(-1, idx), idx
        vals, idx = saved(probs, k)
        record.append(idx)
        return vals, idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = saved


@contextlib.contextmanager
def rank_routing(calls, replay, tally, dm, axes):
    """``models.moe.top_k`` on a rank, held call by call on its own groups
    against ``calls``, an iterator over the one-device run's choices (each
    (G, Tg, k)): the tokens whose expert set differs are counted into
    ``tally``, and with ``replay`` the one-device choices are returned
    with this rank's own probabilities for them (bf16 rounds the router's
    logits, so a near-tie can fall either way on the two runs)."""
    from repro_torch.models import moe
    saved = moe.top_k

    def top_k(probs, k):
        vals, idx = saved(probs, k)
        full = torch.as_tensor(next(calls), device=probs.device).long()
        want = full[_group_slice(dm, axes, full.shape[0], probs.shape[0])]
        tally["flips"] += routing_flips([idx], [want])
        tally["tokens"] += int(np.prod(idx.shape[:-1]))
        if replay:
            return probs.gather(-1, want), want
        return vals, idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = saved


def _routing(cfg, dtype, record, calls, dm, axes, tally):
    """One device: ``moe_routing`` recording into ``record``; a rank:
    ``rank_routing`` on ``calls`` (replayed in bf16); nothing for a model
    without experts."""
    if not cfg.is_moe:
        return contextlib.nullcontext()
    if dm is None:
        return moe_routing(record=record)
    return rank_routing(calls, dtype == BF16, tally, dm, axes)


def _bytes_held(tree):
    """Bytes of the storage under ``tree``'s tensors (a DTensor's local
    shard)."""
    from repro_torch.train.optimizer import tree_leaves
    return sum((t.to_local() if hasattr(t, "to_local") else t)
               .untyped_storage().nbytes()
               for t in tree_leaves(tree) if torch.is_tensor(t))


def plan_state_bytes(cfg, dtype, mesh):
    """(plan, extra): the plan's parameter and optimizer bytes a device
    (``launch.dryrun.plan_bytes`` of ``build_case``'s train case, in JAX's
    dtypes), and the bytes a device of the port's step holds beyond them
    by the two differences ``launch.specs`` documents: the block vectors
    (float32 leaves of rank < 2 that JAX stacks to rank >= 2 and casts to
    ``dtype``) stay float32, and the optimizer step is a host int, not
    the plan's int32 scalar."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import build_case_from_cfg
    case = build_case_from_cfg(cfg, "train_4k", mesh, compute_dtype=dtype)
    got = dryrun.plan_bytes(case, mesh)
    params, opt = case["args"][:2]
    p_sh = case["in_specs"][0]
    kept = sh.map_with_path(
        lambda _, t: (torch.empty(t.shape, dtype=F32, device=t.device)
                      if t.dim() < 2 and t.dtype != F32 else t), params)
    extra = (sh.shard_bytes(kept, p_sh, mesh)
             - sh.shard_bytes(params, p_sh, mesh) - opt.step.element_size())
    return got["params"] + got["optimizer"], extra


def mesh_train_run(cfg, dtype, b, dev, mesh=None, dm=None, ref=None, *,
                   seq=SEQ, steps=STEPS):
    """``steps`` AdamW steps of ``cfg`` at B ``b`` x ``seq`` inside
    ``activation_sharding`` on ``mesh`` (the 2 x 2 test mesh if None)
    with the batch axes ``pick_batch_axes`` picks, so that MoE routes in
    as many groups on one device as on the mesh: on one device (``dm``
    None; MoE's expert choices returned as ``routes``) or through
    ``build_case``'s step on the mesh (MoE held on ``ref``'s choices,
    ``rank_routing``).  Per step: ce, grad_norm and wall (s, ending in a
    sync); the peak GiB; on the mesh, DTensor's collectives of the first
    step by kind (``CommDebugMode``, whose dispatch hook slows that step;
    the later steps run without it), and the bytes of this rank's
    parameter and optimizer storage."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import build_case_from_cfg
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.utils.dist import dtensor_collectives
    from repro_torch.utils.pjit_utils import activation_sharding
    tc = TrainConfig(compute_dtype=dtype, master_weights=dtype != F32)
    mesh = mesh or make_test_mesh(2, 2)
    model, opt = _mesh_model(cfg, dev, mesh, dm, "train", tc)
    params = model.tree()
    axes = sh.pick_batch_axes(mesh, b, allow_model=True)
    out = dict(ce=[], grad_norm=[], wall_s=[], collectives={},
               batch_axes=list(axes))
    if dm is None:
        step = make_train_step(model, tc)
    else:
        step = build_case_from_cfg(cfg, "train_4k", mesh,
                                   compute_dtype=dtype)["fn"]
        out["state_bytes"] = _bytes_held((params, opt))
    routes, tally = [], dict(flips=0, tokens=0)
    calls = iter(ref or ())
    _reset_peak(dev)
    for i in range(steps):
        batch = mesh_batch(cfg, b, seq, 100 + i, dev)
        if dm is not None:
            batch = sh.distribute(batch, sh.batch_shardings(batch, mesh,
                                                            axes), mesh, dm)
        counted = (dtensor_collectives() if i == 0 and dm is not None
                   else contextlib.nullcontext((None, None)))
        _sync(dev)
        t0 = tick()
        with activation_sharding(mesh, axes, dm), counted as (mode, _), \
                _routing(cfg, dtype, routes, calls, dm, axes, tally):
            params, opt, metrics = step(params, opt, batch)
            _sync(dev)
        out["wall_s"].append(tick() - t0)
        out["ce"].append(float(metrics["ce"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if mode is not None:
            out["collectives"] = {str(k).split(".")[-1]: v for k, v in
                                  mode.get_comm_counts().items()}
    out["peak_gib"] = _peak_gib(dev)
    if cfg.is_moe:
        if dm is None:
            out["routes"] = [r.cpu().numpy().astype(np.int16)
                             for r in routes]
        else:
            out["routing"] = tally
    del model, params, opt
    _free(dev)
    return out


def mesh_generate_run(cfg, b, prompt, dtype, dev, fed=None, mesh=None,
                      dm=None, ref=None, *, new=NEW, segments=1, plant=None):
    """Prefill ``prompt`` tokens (a vlm's after its image embeds) in
    ``segments`` equal calls on one cache, then ``new`` - 1 decode steps
    (fed the tokens ``fed``, else greedy), inside
    ``activation_sharding`` as ``mesh_train_run``'s: the logits of each
    step, the tokens fed, the wall, the peak GiB, the attention cache's
    slots and a rank's share of them (none for rwkv6), and MoE's expert
    choices (one device) or their flips against ``ref`` (the mesh,
    replayed in bf16).  ``plant``: a fault applied to the cache after the
    prefill, on the mesh only (``PLANTS``).  On the mesh, every state and
    cache leaf must have the plan's placements
    (``sharding.cache_shardings``) before prefill, after each prefill call
    and after each decode step, and one more decode step after
    the timed ones, with DTensor's collectives recorded (``utils.dist.
    dtensor_collectives``), must all-gather no state or cache shard: of a
    leaf itself or a view of it (its storage), or of as many elements as
    a rank's shard of a layer's k or v cache.  This rank raises at once
    where either fails; its collectives in that step are returned by kind
    with the largest all-gather's elements."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import build_case_from_cfg
    from repro_torch.utils.dist import dtensor_collectives
    from repro_torch.utils.pjit_utils import activation_sharding
    mesh = mesh or make_test_mesh(2, 2)
    model, _ = _mesh_model(cfg, dev, mesh, dm, "serve")
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    max_len = prefix + prompt + new + 8
    parts = segment_batch(mesh_batch(cfg, b, prompt, 7, dev), segments)
    params = model.weights(dtype)
    cache = model.init_cache(b, max_len, dtype=dtype)
    axes = sh.pick_batch_axes(mesh, b, allow_model=False)
    if dm is None:
        prefill = lambda p, x, c: model.prefill(x, c, dtype)  # noqa: E731
        decode = lambda p, t, c: model.decode_step(t, c, dtype)  # noqa: E731
    else:
        cache = sh.distribute(cache, sh.cache_shardings(cache, cfg, mesh),
                              mesh, dm)
        parts = [sh.distribute(p, sh.batch_shardings(p, mesh, axes), mesh,
                               dm) for p in parts]
        prefill = build_case_from_cfg(cfg, "prefill_32k", mesh,
                                      compute_dtype=dtype)["fn"]
        decode = build_case_from_cfg(cfg, "decode_32k", mesh,
                                     compute_dtype=dtype)["fn"]
    c_specs = sh.cache_shardings(cache, cfg, mesh)["blocks"]
    checks = []

    def leaves():
        return list(sh.leaves_with_specs(cache["blocks"], c_specs))

    def placed(when):
        """Raise where a leaf has left the plan's placements (the mesh)."""
        if dm is None:
            return
        bad = [p for p, t, spec in leaves()
               if tuple(t.placements) != sh.placements(spec, mesh)]
        if bad:
            raise AssertionError(
                f"rank {dist.get_rank()}: {cfg.name} {str(dtype)[6:]} "
                f"{when}: cache or state leaves off the plan's placements "
                f"{bad}")
        checks.append(when)

    logits, sent, counts, largest = [], [], {}, 0
    k0 = next((t for p, t, _ in leaves() if p.endswith("/k")), None)
    local = k0.to_local() if dm is not None and k0 is not None else k0
    shard = int(np.prod(local.shape) if dm is not None and k0 is not None
                else 0)
    routes, tally = [], dict(flips=0, tokens=0)
    placed("before prefill")
    _reset_peak(dev)
    _sync(dev)
    t0 = tick()
    with activation_sharding(mesh, axes, dm):
        with _routing(cfg, dtype, routes, iter(ref or ()), dm, axes, tally):
            for j, part in enumerate(parts):
                out, cache = prefill(params, part, cache)
                if j < segments - 1:
                    placed(f"after prefill segment {j}")
                    logits.append(_full(out).float().cpu().numpy())
            if plant is not None and dm is not None:
                plant(cache)
            for i in range(new):
                placed("after prefill" if i == 0 else f"after decode {i}")
                full = _full(out)
                logits.append(full.float().cpu().numpy())
                if i == new - 1:
                    break
                tok = (torch.from_numpy(fed[i]).to(dev) if fed is not None
                       else full.argmax(-1).to(torch.int32))
                sent.append(tok.cpu().numpy())
                out, cache = decode(params, tok, cache)
            _sync(dev)
            wall = tick() - t0
        if dm is not None:
            held = {t.to_local().untyped_storage().data_ptr()
                    for _, t, _ in leaves()}
            with dtensor_collectives() as (mode, calls):
                _, cache = decode(params, tok, cache)
            placed("after the counted decode step")
            counts = {str(k).split(".")[-1]: v
                      for k, v in mode.get_comm_counts().items()}
            gathers = [c for c in calls if "gather" in c.name]
            largest = max([0] + [int(np.prod(c.shape)) for c in gathers])
            cache_gathers = [list(c.shape) for c in gathers
                             if c.storage in held
                             or int(np.prod(c.shape)) == shard]
            if cache_gathers:
                raise AssertionError(
                    f"rank {dist.get_rank()}: {cfg.name} {str(dtype)[6:]}: "
                    f"a decode step all-gathers a state or cache shard: "
                    f"{cache_gathers}")
    res = dict(logits=np.stack(logits), fed=np.stack(sent), wall_s=wall,
               peak_gib=_peak_gib(dev), decode_collectives=counts,
               largest_gather=largest, cache_shard=shard,
               placement_checks=len(checks),
               cache_slots=(None if k0 is None else
                            [int(k0.shape[1]), int(local.shape[1])]))
    if cfg.is_moe:
        if dm is None:
            res["routes"] = [r.cpu().numpy().astype(np.int16)
                             for r in routes]
        else:
            res["routing"] = tally
    del model, params, cache
    _free(dev)
    return res


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def segment_batch(batch, n):
    """``batch`` as ``n`` prefill calls: its tokens cut into n equal spans
    along the sequence, a vlm's image embeds in the first alone."""
    if n == 1:
        return [batch]
    s = batch["tokens"].shape[1]
    if s % n:
        raise ValueError(f"a prompt of {s} tokens in {n} equal segments")
    parts = [dict(batch, tokens=batch["tokens"][:, i * s // n:
                                                 (i + 1) * s // n])
             for i in range(n)]
    if "image_embeds" in batch:
        img = batch["image_embeds"]
        for part in parts[1:]:
            part["image_embeds"] = img[:, :0]
    return parts


# ---------------------------------------------------------------------------
# the runs held against one device
# ---------------------------------------------------------------------------

def _flips(by_rank):
    """A run's routing flips by rank, as "flips/tokens" (None where the run
    has no experts)."""
    if by_rank[0] is None:
        return None
    return [f"{t['flips']}/{t['tokens']}" for t in by_rank]


def _train_errs(got, one):
    return {k: max(abs(m - o) / abs(o) for m, o in zip(got[k], one[k]))
            for k in ("ce", "grad_norm")}


def _logit_errs(got, want):
    """Each step's max |got - want| over max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max()))
    return [float(np.abs(g - w).max()) / scale for g, w in zip(got, want)]


def _train_err(errs, dtype):
    """The error a train run is held by: ce's in bf16 (the train
    contract's), the larger of ce's and grad_norm's in f32."""
    return errs["ce"] if dtype != F32 else max(errs["ce"], errs["grad_norm"])


def _held(limit, floor):
    """(limit, which, the words the output line gives them)."""
    held, which = held_limit(limit, floor)
    return held, which, (f"held to {held:.3e} ({which}; floor "
                         + ("not measured" if floor is None
                            else f"{floor:.3e}") + ")")


def train_row(name, cfg, dtype, b, seq, one, mesh, routing, floor=None):
    """A train run on the mesh (rank 0's results) against the same run on
    one device: (row, ok, line).  ``routing``: each rank's MoE tally;
    ``floor``: the run's floor (``held_limit``), None where not measured."""
    errs = _train_errs(mesh, one)
    flips = _flips(routing)
    dt = str(dtype)[6:]
    limit, which, held = _held(TRAIN_RTOL[dtype], floor)
    ok = _train_err(errs, dtype) <= limit
    row = dict(arch=name, layers=cfg.n_layers, dtype=dt, batch=b, seq=seq,
               batch_axes=mesh["batch_axes"], ce=mesh["ce"],
               ce_one_device=one["ce"], grad_norm=mesh["grad_norm"],
               grad_norm_one_device=one["grad_norm"], rel_err=errs,
               limit=limit, held_by=which, floor=floor,
               wall_s=mesh["wall_s"],
               wall_s_one_device=one["wall_s"], peak_gib=mesh["peak_gib"],
               peak_gib_one_device=one["peak_gib"],
               collectives=mesh["collectives"], routing_flips=flips)
    line = (f"train {name} ({cfg.n_layers} layers) {dt} B{b}x{seq} over "
            f"{mesh['batch_axes']}: ce {mesh['ce']} (one device "
            f"{one['ce']}), rel err ce {errs['ce']:.2e} grad_norm "
            f"{errs['grad_norm']:.2e} {held}, wall/step {mesh['wall_s']} s "
            f"(one device {one['wall_s']}), peak {_gib(mesh['peak_gib'])} a "
            f"rank (one device {_gib(one['peak_gib'])}), collectives/step "
            f"{mesh['collectives']}"
            + (f", routing flips by rank {flips}"
               + (" (replayed)" if dtype == BF16 else "") if flips else "")
            + f" {'ok' if ok else 'FAIL'}")
    return row, ok, line


def generate_row(name, cfg, dtype, b, prompt, new, one, mesh, logits,
                 routing, floor=None, segments=1):
    """A generate on the mesh (rank 0's results and ``logits``) against the
    same generate on one device: (row, ok, line).  ``floor`` as
    ``train_row``'s; ``segments``: the prefill calls of the prompt."""
    want = one["logits"]
    steps = _logit_errs(logits, want)
    err = max(steps)
    same = bool((logits.argmax(-1) == want.argmax(-1)).all())
    flips = _flips(routing)
    dt = str(dtype)[6:]
    limit, which, held = _held(LOGIT_TOL[dtype], floor)
    ok = (err <= limit and bool(np.isfinite(logits).all())
          and logits.shape == want.shape and (same or dtype != F32)
          and mesh["placement_checks"] == new + segments + 1)
    row = dict(arch=name, layers=cfg.n_layers, dtype=dt, batch=b,
               prompt=prompt, new=new, segments=segments, logit_err=err,
               logit_err_steps=steps, limit=limit, held_by=which,
               floor=floor, tokens_equal=same,
               wall_s=mesh["wall_s"], wall_s_one_device=one["wall_s"],
               decode_collectives=mesh["decode_collectives"],
               largest_gather=mesh["largest_gather"],
               cache_shard=mesh["cache_shard"],
               placement_checks=mesh["placement_checks"],
               peak_gib=mesh["peak_gib"], peak_gib_one_device=one["peak_gib"],
               cache_slots=mesh["cache_slots"], routing_flips=flips)
    line = (f"generate {name} ({cfg.n_layers} layers) {dt} B{b} prompt "
            f"{prompt}" + (f" in {segments} prefill calls" if segments > 1
                           else "") + f" + {new}: logits err {err:.3e} of "
            f"max(1, |logit|) {held} (prefill {steps[0]:.3e}, later "
            f"steps up to {max(steps[1:], default=0.0):.3e}), tokens equal "
            f"{same}, wall {mesh['wall_s']:.2f} s (one device "
            f"{one['wall_s']:.2f}), collectives/decode step "
            f"{mesh['decode_collectives']}, largest all-gather "
            f"{mesh['largest_gather']} elements, none of a state or cache "
            f"shard (a layer's k or v cache shard: {mesh['cache_shard']}), "
            f"every leaf in the plan's placements at "
            f"{mesh['placement_checks']} checks, cache slots / a rank "
            f"{mesh['cache_slots']}, peak {_gib(mesh['peak_gib'])} a rank "
            f"(one device {_gib(one['peak_gib'])})"
            + (f", routing flips by rank {flips}"
               + (" (replayed)" if dtype == BF16 else "") if flips else "")
            + f" {'ok' if ok else 'FAIL'}")
    return row, ok, line


def planted_row(name, cfg, dtype, fault, one, logits, limit):
    """A planted fault's generate against the one-device run: it must miss
    ``limit``, the limit that holds the fault-free row.  (row, ok, line)."""
    err = max(_logit_errs(logits, one["logits"]))
    caught = not err <= limit
    row = dict(arch=name, layers=cfg.n_layers, dtype=str(dtype)[6:],
               fault=fault, logit_err=err, limit=limit, caught=caught)
    line = (f"planted {fault}: {name} ({cfg.n_layers} layers) "
            f"{str(dtype)[6:]} generate logits err {err:.3e} against the "
            f"row's limit {limit:.3e}: "
            f"{'caught ok' if caught else 'not caught FAIL'}")
    return row, caught, line


def _gib(x):
    return "not measured" if x is None else f"{x:.2f} GiB"


# ---------------------------------------------------------------------------
# the SPMD entry point
# ---------------------------------------------------------------------------

def _runs(args):
    """(train, generate, segmented, mesh-only) runs of ``args``: one (label,
    cfg, dtype, batch) a train run, one (label, cfg, batch, prompt, dtype)
    a generate, one (label, cfg, batch, prompt, dtype, segments) a
    segmented generate, ``--arch`` picking archs."""
    pick = set(args.arch.split(",")) if args.arch else None

    def cfg(arch, depth):
        return local_cfg(arch) if args.local else mesh_cfg(arch, depth)

    def keep(arch):
        return pick is None or arch in pick

    prompt = (lambda p: LOCAL["prompt"]) if args.local else (lambda p: p)
    return ([(a, cfg(a, d), dt, b) for a, d, dt, b in TRAIN if keep(a)],
            [(a, cfg(a, d), b, prompt(p), dt)
             for a, d, b, p, dt in gen_runs(GEN) if keep(a)],
            [(a, cfg(a, d), b, prompt(p), dt, n)
             for a, d, b, p, n, dts in SEGMENTED for dt in dts if keep(a)],
            [(a, cfg(a, d), dt, b) for a, d, dt, b in MESH_ONLY if keep(a)])


def one_device_floors(trains, gens, ones, dev, mesh, seq, new):
    """Rank 0: the floor of each train and generate run of FLOOR_ARCHS (None
    for the others): each seed's one-device run with its weights perturbed
    (``sharded_lm_floor.perturbed``), a generate fed the unperturbed run's
    tokens, against the unperturbed run; the largest error of the seeds
    (``_train_err``; a generate's largest logit error a step)."""
    from repro_torch.examples.sharded_lm_floor import perturbed
    floors = dict(train=[], gen=[])
    for (name, c, dt, b), one in zip(trains, ones["train"]):
        errs = []
        for seed in FLOOR_SEEDS if name in FLOOR_ARCHS else ():
            with perturbed(seed):
                run = mesh_train_run(c, dt, b, dev, mesh, seq=seq)
            errs.append(_train_err(_train_errs(run, one), dt))
        floors["train"].append(max(errs) if errs else None)
    for (name, c, b, p, dt), one in zip(gens, ones["gen"]):
        errs = []
        for seed in FLOOR_SEEDS if name in FLOOR_ARCHS else ():
            with perturbed(seed):
                run = mesh_generate_run(c, b, p, dt, dev, one["fed"], mesh,
                                        new=new)
            errs.append(max(_logit_errs(run["logits"], one["logits"])))
        floors["gen"].append(max(errs) if errs else None)
    return floors


def run_all(args, dev):
    """Every run: rank 0's one-device runs (and the floors of FLOOR_ARCHS'
    runs), then the mesh runs on every rank, held on rank 0, then the
    planted faults.  Returns rank 0's report (None elsewhere)."""
    import torch.distributed as dist
    from repro_torch.kernels import cache_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    mesh = make_test_mesh(2, 2)
    dm = device_mesh(mesh, dev.type)
    rank = dist.get_rank()
    seq = LOCAL["seq"] if args.local else SEQ
    new = LOCAL["new"] if args.local else NEW
    trains, gens, segs, alone = _runs(args)
    plants = [(i, fault) for i, (name, _, _, _, dt) in enumerate(gens)
              if name in FLOOR_ARCHS and dt == F32 for fault in PLANTS]
    t0 = tick()
    ones = replay = floors = None
    if rank == 0:
        ones = dict(train=[mesh_train_run(c, dt, b, dev, mesh, seq=seq)
                           for _, c, dt, b in trains],
                    gen=[mesh_generate_run(c, b, p, dt, dev, mesh=mesh,
                                           new=new)
                         for _, c, b, p, dt in gens],
                    seg=[mesh_generate_run(c, b, p, dt, dev, mesh=mesh,
                                           new=new, segments=n)
                         for _, c, b, p, dt, n in segs])
        floors = one_device_floors(trains, gens, ones, dev, mesh, seq, new)
        replay = dict(train=[r.pop("routes", None) for r in ones["train"]],
                      gen=[(r.pop("fed"), r.pop("routes", None))
                           for r in ones["gen"]],
                      seg=[(r.pop("fed"), r.pop("routes", None))
                           for r in ones["seg"]])
    box = [replay]
    dist.broadcast_object_list(box, src=0, device=torch.device("cpu"))
    replay = box[0]
    one_s = tick() - t0
    FA.reset_counts()
    DA.reset_counts()
    CA.reset_counts()
    t1 = tick()
    with collectives_for(dev):
        mtrain = [mesh_train_run(c, dt, b, dev, mesh, dm, replay["train"][i],
                                 seq=seq)
                  for i, (_, c, dt, b) in enumerate(trains)]
        mgen = [mesh_generate_run(c, b, p, dt, dev, replay["gen"][i][0],
                                  mesh, dm, replay["gen"][i][1], new=new)
                for i, (_, c, b, p, dt) in enumerate(gens)]
        mseg = [mesh_generate_run(c, b, p, dt, dev, replay["seg"][i][0],
                                  mesh, dm, replay["seg"][i][1], new=new,
                                  segments=n)
                for i, (_, c, b, p, dt, n) in enumerate(segs)]
        malone = [mesh_train_run(c, dt, b, dev, mesh, dm, seq=seq)
                  for _, c, dt, b in alone]
        launches = {**FA.COUNTS, **DA.COUNTS, **CA.COUNTS}
        mplant = [mesh_generate_run(gens[i][1], gens[i][2], gens[i][3],
                                    gens[i][4], dev, replay["gen"][i][0],
                                    mesh, dm, new=new, plant=PLANTS[fault])
                  for i, fault in plants]
    mesh_s = tick() - t1
    mine = dict(launches=launches,
                routing=[r.get("routing") for r in mtrain + mgen],
                alone=[dict(ce=r["ce"], peak_gib=r["peak_gib"],
                            state_bytes=r["state_bytes"])
                       for r in malone])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    report = dict(ranks=dist.get_world_size(), mesh="2x2 (data, model)",
                  device=(torch.cuda.get_device_name() if dev.type == "cuda"
                          else "cpu"),
                  backend=dist.get_backend_config(),
                  gloo_collectives=through_gloo(dev), local=args.local,
                  one_device_s=one_s, mesh_s=mesh_s, floor_seeds=list(
                      FLOOR_SEEDS), train=[], generate=[], segments=[],
                  planted=[], mesh_only=[], ok=True)

    def add(key, row, ok, line):
        report[key].append(row)
        report["ok"] &= ok
        print(f"sharded_lm {line}", flush=True)

    routing = [[r["routing"][i] for r in every]
               for i in range(len(trains) + len(gens))]
    for i, ((name, c, dt, b), one, got) in enumerate(
            zip(trains, ones["train"], mtrain)):
        add("train", *train_row(name, c, dt, b, seq, one, got, routing[i],
                                floors["train"][i]))
    for i, ((name, c, b, p, dt), one, got) in enumerate(
            zip(gens, ones["gen"], mgen)):
        add("generate", *generate_row(
            name, c, dt, b, p, new, one, got, got.pop("logits"),
            routing[len(trains) + i], floors["gen"][i]))
    for (name, c, b, p, dt, n), one, got in zip(segs, ones["seg"], mseg):
        add("segments", *generate_row(name, c, dt, b, p, new, one, got,
                                      got.pop("logits"), [None],
                                      segments=n))
    for (i, fault), got in zip(plants, mplant):
        name, c, _, _, dt = gens[i]
        add("planted", *planted_row(name, c, dt, fault, ones["gen"][i],
                                    got["logits"],
                                    report["generate"][i]["limit"]))
    for i, ((name, c, dt, b), got) in enumerate(zip(alone, malone)):
        add("mesh_only", *alone_row(name, c, dt, b, seq, mesh, got,
                                    [r["alone"][i] for r in every]))
    report["launches"] = {k: sum(r["launches"][k] for r in every)
                          for k in ("flash_attention", "decode_attention",
                                    "cache_attention")}
    report["launches_by_rank"] = [r["launches"] for r in every]
    return report


def alone_row(name, cfg, dtype, b, seq, mesh, got, by_rank):
    """A mesh-only train run: ce finite and equal on every rank, and each
    rank's parameter and optimizer bytes exactly the plan's a device
    (``plan_state_bytes``: JAX's dtypes, plus what the port documents
    holding beyond them).  (row, ok, line)."""
    ce = [r["ce"] for r in by_rank]
    finite = all(np.isfinite(c).all() for c in ce)
    held = [r["state_bytes"] for r in by_rank]
    plan, extra = plan_state_bytes(cfg, dtype, mesh)
    ok = (finite and all(c == ce[0] for c in ce)
          and all(h == plan + extra for h in held))
    dt = str(dtype)[6:]
    row = dict(arch=name, layers=cfg.n_layers, dtype=dt, batch=b, seq=seq,
               batch_axes=got["batch_axes"], ce=got["ce"], ce_by_rank=ce,
               grad_norm=got["grad_norm"], wall_s=got["wall_s"],
               peak_gib_by_rank=[r["peak_gib"] for r in by_rank],
               state_bytes_by_rank=held, plan_state_bytes=plan,
               port_extra_bytes=extra, collectives=got["collectives"])
    line = (f"mesh only: train {name} ({cfg.n_layers} layers) {dt} "
            f"B{b}x{seq}: ce {got['ce']} on every rank "
            f"{'equal' if all(c == ce[0] for c in ce) else ce}, wall/step "
            f"{got['wall_s']} s, peak by rank "
            f"{[_gib(r['peak_gib']) for r in by_rank]}, parameter and "
            f"optimizer bytes by rank {held} (the plan's {plan} a device in "
            f"JAX's dtypes, + {extra} for the port's float32 block vectors "
            f"and host-int step), "
            f"collectives/step {got['collectives']} {'ok' if ok else 'FAIL'}")
    return row, ok, line


def start_group(device=None):
    """The rank's device (``device``, else the card) and the default group
    as ``federated.runtime.init_default_group`` makes it, with the group's
    timeout ``TIMEOUT_S``; on the card the rank's own card first
    (``LOCAL_RANK``), before the group exists: NCCL binds to it."""
    from repro_torch.federated.runtime import init_default_group
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    init_default_group(timedelta(seconds=TIMEOUT_S))
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--local", action="store_true",
                    help="the reduced configs at LOCAL's sizes")
    ap.add_argument("--arch", default="",
                    help="comma-separated archs to run (default: all)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    dev = start_group(args.device)
    # a rank that raises leaves the group as it is: the launcher stops
    # the others (a rank in a collective with it would wait in teardown)
    report = run_all(args, dev)
    dist.destroy_process_group()
    if report is not None:
        print(json.dumps({"sharded_lm": report}), flush=True)
        if not report["ok"]:
            raise SystemExit("sharded_lm: a run missed its limits")
    return report


if __name__ == "__main__":
    main()
