"""The sharded runtime: MOCHA's tasks over the ranks of a process group.

    # one rank (a group made on first use)
    PYTHONPATH=src python -m repro_torch.examples.sharded [--device cpu]
    # k ranks: gloo on the CPU, NCCL over k cards
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node k \
        --master_addr localhost -m repro_torch.examples.sharded

Every rank runs this whole script (SPMD) on the same federation; the
sharded engine gives each rank a contiguous block of tasks and exchanges
the round's Delta v with one all-gather.  Rank 0 prints one JSON line:
whether every rank holds the same result, its distance from the local
engine's run of the same experiment, the walls per round, and the
gathers of a round (shape, dtype, bytes).
"""
import argparse
import json
import math
import os

import numpy as np

from repro_torch.utils.timing import tick


def _timed(fn, dev):
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = tick()
    out = fn()
    sync()
    return out, tick() - t0


def _spec(name):
    from repro_torch.data import synthetic
    if name == "tiny":
        return synthetic.FederationSpec("tiny", m=5, d=6, n_min=24,
                                        n_max=24, clusters=2,
                                        label_noise=0.0)
    return {"vehicle_sensor": synthetic.VEHICLE_SENSOR,
            "human_activity": synthetic.HUMAN_ACTIVITY}[name]


def run_sharded(args):
    import torch
    import torch.distributed as dist
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.core import Clustered, ShardedEngine
    from repro_torch.data.synthetic import make_federation
    from repro_torch.federated import make_federated_mesh
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.dist import counted_collectives
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    train = make_federation(_spec(args.spec), seed=0, device=dev)[0]
    mesh = make_federated_mesh(device=dev)

    def run(engine):
        return Experiment(
            problem=Problem(train=train),
            method=Method(regularizers=(Clustered(lam=1.0, k=3),),
                          rounds=args.rounds, omega_update_every=5),
            exec=Exec(engine=engine, driver="loop", device=str(dev)),
            eval=Eval(record_every=1)).run(0)

    engine = ShardedEngine(mesh=mesh, comm_dtype=args.comm_dtype)
    run(engine)                                   # warm
    with counted_collectives() as calls:
        sharded, wall_s = _timed(lambda: run(engine), dev)
    gathers = [(list(c.shape), str(c.dtype),
                math.prod(c.shape) * c.dtype.itemsize) for c in calls]
    local, wall_l = _timed(lambda: run("local"), dev)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (sharded.result.W, sharded.history))
    primal = np.abs(np.asarray(local.history["primal"]))
    report = dict(
        ranks=mesh.size(), backend=dist.get_backend_config(),
        m=train.m, d=train.d, comm_dtype=str(engine.comm_dtype),
        ranks_equal=all(np.array_equal(W, every[0][0]) and h == every[0][1]
                        for W, h in every),
        clock_equal=sharded.history["time"] == local.history["time"],
        rel_vs_local={k: float(np.max(np.abs(
            np.asarray(sharded.history[k])
            - np.asarray(local.history[k])) / primal))
            for k in ("dual", "primal", "gap")},
        W_err=float(np.abs(sharded.result.W - local.result.W).max()),
        wall_ms_per_round=dict(sharded=1e3 * wall_s / args.rounds,
                               local=1e3 * wall_l / args.rounds),
        gathers_per_round=gathers[:len(gathers) // args.rounds])
    if dist.get_rank() == 0:
        print(json.dumps({"sharded": report}), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default="vehicle_sensor",
                    choices=("vehicle_sensor", "human_activity", "tiny"))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--comm-dtype", default=None,
                    help="the Delta v wire's dtype, e.g. bfloat16")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_sharded(args)


if __name__ == "__main__":
    main()
