"""A model's rounding floor beside the sharded LM step's error: the
``examples.sharded_lm`` runs of rwkv6-7b on the 2 x 2 mesh against one
device, at several depths, each beside the one-device run against itself
with every weight scaled by (1 + ``PERTURB`` x N(0, 1)), about float32's
rounding, under each of ``SEEDS``.

    # four cards, one NCCL rank each
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        --master_addr localhost -m repro_torch.examples.sharded_lm_floor
    # four gloo ranks on the CPU, the reduced config
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        --master_addr localhost -m repro_torch.examples.sharded_lm_floor \
        --device cpu --local

A probe, not a check: it holds nothing and exits 0 whatever the errors.
The floor says how far the model amplifies a perturbation of the size of
its rounding.  Where the mesh meets ``sharded_lm``'s limits at a depth
whose floor is under them, and the mesh's error at the deeper depths
stays within the floors' spread, the error is the model's and not the
mesh's.  Rank 0 runs every one-device run (the reference, then one
perturbed run a seed), hands the ranks the reference's decode tokens,
every rank runs the mesh, and rank 0 prints a line a run and one JSON
line ``{"sharded_lm_floor": ...}``: per run and step the relative ce and
grad_norm errors (train) or the logit errors of max(1, max |logit|)
(generate), of the mesh and of each seed's floor, with the one-device
values and the limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.examples import sharded_lm as S

#: the arch whose errors at depth exceed ``sharded_lm``'s limits
ARCH = "rwkv6-7b"
#: each weight scaled by (1 + PERTURB x N(0, 1)), drawn from each seed
PERTURB = 1e-7
SEEDS = (1, 2, 3)
#: bf16 train at B 4 x SEQ up to rwkv6-7b's 14 layers, the deepest whose
#: one-device step fits a card (``sharded_lm.TRAIN``); f32 and bf16
#: generates at B 2 x 256 + NEW up to all 32
TRAIN_DEPTHS = (2, 4, 8, 14)
GEN_DEPTHS = (2, 8, 16, 32)
TRAIN_B, GEN_B, PROMPT = 4, 2, 256
#: ``--local``: the reduced config's depths and the seeds
LOCAL_DEPTHS, LOCAL_SEEDS = (1, 2), (1, 2)


@contextlib.contextmanager
def perturbed(draw):
    """``models.build_model`` (which the runs build through) scaling every
    weight of the model it builds by (1 + PERTURB x N(0, 1)), drawn from
    the seed ``draw``."""
    from repro_torch import models
    build = models.build_model

    def build_model(cfg, device=None, seed=0):
        model = build(cfg, device=device, seed=seed)
        gen = torch.Generator(device=device).manual_seed(draw)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + PERTURB * torch.randn(
                    p.shape, generator=gen, device=p.device, dtype=p.dtype))
        return model

    models.build_model = build_model
    try:
        yield
    finally:
        models.build_model = build


def _rel(got, want):
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def train_row(cfg, b, seq, one, mesh, floors):
    """A bf16 train run: the mesh's and each floor's relative ce and
    grad_norm errors a step against the one-device run."""
    limit = S.TRAIN_RTOL[S.BF16]
    err = {k: _rel(mesh[k], one[k]) for k in ("ce", "grad_norm")}
    base = {s: {k: _rel(f[k], one[k]) for k in ("ce", "grad_norm")}
            for s, f in floors.items()}
    worst = max(max(f["ce"]) for f in base.values())
    row = dict(kind="train", layers=cfg.n_layers, dtype="bfloat16", batch=b,
               seq=seq, limit=limit, ce_one_device=one["ce"],
               grad_norm_one_device=one["grad_norm"], ce_mesh=mesh["ce"],
               grad_norm_mesh=mesh["grad_norm"], rel_err=err,
               rel_err_floor=base, meets_limit=max(err["ce"]) <= limit,
               floor_under_limit=worst <= limit,
               within_floors=max(err["ce"]) <= worst)
    line = (f"train {cfg.name} ({cfg.n_layers} layers) bf16 B{b}x{seq}: "
            f"rel err a step ce {_e(err['ce'])} grad_norm "
            f"{_e(err['grad_norm'])} (limit ce {limit:g}); floor by seed "
            + "; ".join(f"{s}: ce {_e(f['ce'])} grad_norm "
                        f"{_e(f['grad_norm'])}" for s, f in base.items())
            + f"; grad_norm one device {one['grad_norm']}")
    return row, line


def generate_row(cfg, dtype, b, prompt, one, mesh, floors):
    """A generate: the mesh's and each floor's logit errors a step of
    max(1, max |logit|) against the one-device run."""
    limit = S.LOGIT_TOL[dtype]
    want = one["logits"]
    err = S._logit_errs(mesh["logits"], want)
    base = {s: S._logit_errs(f["logits"], want) for s, f in floors.items()}
    worst = max(max(f) for f in base.values())
    row = dict(kind="generate", layers=cfg.n_layers, dtype=str(dtype)[6:],
               batch=b, prompt=prompt, limit=limit, logit_err=err,
               logit_err_floor=base,
               tokens_equal=bool((mesh["logits"].argmax(-1)
                                  == want.argmax(-1)).all()),
               meets_limit=max(err) <= limit,
               floor_under_limit=worst <= limit,
               within_floors=max(err) <= worst)
    line = (f"generate {cfg.name} ({cfg.n_layers} layers) "
            f"{str(dtype)[6:]} B{b} prompt {prompt}: logit err a step "
            f"{_e(err)} (limit {limit:g}); floor by seed "
            + "; ".join(f"{s}: {_e(f)}" for s, f in base.items()))
    return row, line


def _e(xs):
    return "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"


def probe(args, dev):
    """Rank 0's report (None on the other ranks)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    mesh = make_test_mesh(2, 2)
    dm = device_mesh(mesh, dev.type)
    base = S.local_cfg(ARCH) if args.local else S.mesh_cfg(ARCH)

    def cfg(depth):
        return dataclasses.replace(base, n_layers=depth)

    train_depths, gen_depths, seeds = (
        (LOCAL_DEPTHS, LOCAL_DEPTHS, LOCAL_SEEDS) if args.local
        else (TRAIN_DEPTHS, GEN_DEPTHS, SEEDS))
    seq = S.LOCAL["seq"] if args.local else S.SEQ
    prompt = S.LOCAL["prompt"] if args.local else PROMPT
    new = S.LOCAL["new"] if args.local else S.NEW
    trains = [cfg(d) for d in train_depths]
    gens = [(cfg(d), dt) for d in gen_depths for dt in (S.F32, S.BF16)]

    def train(c, dm_=None):
        return S.mesh_train_run(c, S.BF16, TRAIN_B, dev, mesh, dm_, seq=seq)

    def generate(c, dt, fed=None, dm_=None):
        return S.mesh_generate_run(c, GEN_B, prompt, dt, dev, fed, mesh, dm_,
                                   new=new)

    t0 = time.perf_counter()
    ones = floors = fed = None
    if dist.get_rank() == 0:
        ones = dict(train=[train(c) for c in trains],
                    gen=[generate(c, dt) for c, dt in gens])
        fed = [r["fed"] for r in ones["gen"]]
        floors = {}
        for s in seeds:
            with perturbed(s):
                floors[s] = dict(
                    train=[train(c) for c in trains],
                    gen=[generate(c, dt, fed[i])
                         for i, (c, dt) in enumerate(gens)])
    box = [fed]
    dist.broadcast_object_list(box, src=0, device=torch.device("cpu"))
    fed = box[0]
    one_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    with S.collectives_for(dev):
        mtrain = [train(c, dm) for c in trains]
        mgen = [generate(c, dt, fed[i], dm)
                for i, (c, dt) in enumerate(gens)]
    mesh_s = time.perf_counter() - t1
    if dist.get_rank() != 0:
        return None
    report = dict(arch=base.name, ranks=dist.get_world_size(),
                  mesh="2x2 (data, model)",
                  device=(torch.cuda.get_device_name() if dev.type == "cuda"
                          else "cpu"),
                  backend=dist.get_backend_config(),
                  gloo_collectives=S.through_gloo(dev), local=args.local,
                  perturb=PERTURB, seeds=list(seeds), one_device_s=one_s,
                  mesh_s=mesh_s, runs=[])
    for i, c in enumerate(trains):
        row, line = train_row(c, TRAIN_B, seq, ones["train"][i], mtrain[i],
                              {s: f["train"][i] for s, f in floors.items()})
        report["runs"].append(row)
        print(f"sharded_lm_floor {line}", flush=True)
    for i, (c, dt) in enumerate(gens):
        row, line = generate_row(c, dt, GEN_B, prompt, ones["gen"][i],
                                 mgen[i],
                                 {s: f["gen"][i] for s, f in floors.items()})
        report["runs"].append(row)
        print(f"sharded_lm_floor {line}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--local", action="store_true",
                    help="the reduced config at sharded_lm.LOCAL's sizes")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    dev = S.start_group(args.device)
    report = probe(args, dev)
    dist.destroy_process_group()
    if report is not None:
        print(json.dumps({"sharded_lm_floor": report},
                         default=lambda x: np.asarray(x).tolist()),
              flush=True)
    return report


if __name__ == "__main__":
    main()
