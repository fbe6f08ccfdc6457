"""Dry-run of the paper's technique itself on the production mesh: the JAX
package's ``launch/mocha_dryrun.py``.

One distributed MOCHA federated round (``federated.runtime.
distributed_round``) with tasks sharded over the full 256-way ``data``
axis, for a Table-2-scale federation padded to the shard count.  Where
the JAX package compiles the round for 256 devices and reads XLA's
figures, the port runs it as rank 0 of a fake 256-rank process group
(``utils.dist.fake_group``) on real tensors, in this process, and records:

  * ``collectives``: the round's ``torch.distributed`` calls
    (``utils.dist.counted_collectives``) by result bytes, ``hlo_stats``'
    keys: one all-gather of the m x d Delta v wire;
  * ``memory.argument_bytes``: the round's inputs as a rank of the port
    holds them.  The port's round hands every rank the whole federation
    and each reads its block (``memory.block_bytes``: its tasks' rows of
    X, y, mask, alpha, q, budgets, keys and K, and all of v); the JAX
    package's shard holds its block alone;
  * ``memory.temp_bytes``: the round's peak above its inputs on the card
    (``null`` with ``temp_bytes_reason`` under ``--device cpu``);
  * ``cost``: FLOPs and bytes of the rank's own operations
    (``utils.dist.DeviceCost``);
  * ``probe_s`` in place of the JAX package's ``compile_s``: the seconds
    the round took, inputs made.

The fake group's all-gather writes nothing, so v after the round holds
whatever the allocator handed out; no value of the round is read.

    PYTHONPATH=src python -m repro_torch.launch.mocha_dryrun [--m 512] \\
        [--bf16-wire] [--device cpu]

Records land in results/dryrun_torch/mocha_round__data256[_bf16].json.
Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.launch.hlo_stats import collective_bytes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import tick

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
#: the data axis: one pod's devices
RANKS = 256


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def round_inputs(m: int, n: int, d: int, steps: int, device, seed: int = 0):
    """The round's arguments for an m-task federation, drawn from
    ``seed`` on ``device``: X (m, n, d) normal over sqrt(d), labels +-1,
    every point live, alpha and v zero, K the identity, q one, every
    task's budget ``steps``, a key a task."""
    from repro_torch.core.dual import FederatedData
    from repro_torch.utils import prng
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((m, n, d), generator=g, device=device) / d ** 0.5
    y = torch.where(torch.rand((m, n), generator=g, device=device) < 0.5,
                    -1.0, 1.0)
    data = FederatedData(X, y, torch.ones((m, n), device=device))
    return dict(data=data, alpha=torch.zeros((m, n), device=device),
                v=torch.zeros((m, d), device=device),
                K=torch.eye(m, device=device),
                q_t=torch.ones(m, device=device),
                budgets=torch.full((m,), steps, dtype=torch.int32,
                                   device=device),
                keys=prng.split(prng.PRNGKey(seed, device=device), m))


def argument_bytes(inputs, ranks: int) -> tuple:
    """(all of the round's inputs, a rank's block of them): the block is
    1/ranks of every task-major input's rows (K's rows too) and all of v."""
    data = inputs["data"]
    task_major = (data.X, data.y, data.mask, inputs["alpha"], inputs["K"],
                  inputs["q_t"], inputs["budgets"], inputs["keys"])
    whole = _bytes(*task_major, inputs["v"])
    return whole, _bytes(*task_major) // ranks + _bytes(inputs["v"])


def run(m: int = 512, n: int = 2048, d: int = 561, steps: int = 2048,
        bf16_wire: bool = False, device=None, out_dir: str = RESULTS_DIR
        ) -> dict:
    """One round as rank 0 of a fake ``RANKS``-rank group; writes and
    returns the record (module docstring).  Raises where a process group
    exists already."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.losses import get_loss
    from repro_torch.federated.runtime import (AXIS, check_mesh,
                                               distributed_round)
    from repro_torch.utils.dist import (DeviceCost, counted_collectives,
                                        fake_group)
    dev = resolve_device(device)
    comm = torch.bfloat16 if bf16_wire else None
    t0 = tick()
    with fake_group(RANKS):
        mesh = check_mesh(init_device_mesh(dev.type, (RANKS,),
                                           mesh_dim_names=(AXIS,)), dev)
        inputs = round_inputs(m, n, d, steps, dev)
        whole, block = argument_bytes(inputs, RANKS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with counted_collectives() as calls, DeviceCost() as cost:
            out = distributed_round(mesh, get_loss("hinge"), steps,
                                    gamma=1.0, comm_dtype=comm, **inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            temp = torch.cuda.max_memory_allocated(dev) - base
        del out
    coll = collective_bytes(calls)
    memory = {"argument_bytes": whole, "block_bytes": block,
              "temp_bytes": temp if dev.type == "cuda" else None}
    record = {
        "kind": "mocha_federated_round", "m": m, "n": n, "d": d,
        "steps": steps, "bf16_wire": bf16_wire, "mesh": f"data{RANKS}",
        "status": "ok", "device": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu"),
        "probe_s": tick() - t0,
        "memory": memory,
        "cost": {"flops": float(cost.flops), "bytes": float(cost.bytes)},
        "collectives": coll,
        "calls": [[c.name, list(c.shape), str(c.dtype)] for c in calls],
    }
    if dev.type == "cpu":
        memory["temp_bytes_reason"] = (
            "the card's only: read from the card's allocator, and this run "
            "is --device cpu")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"mocha_round__data{RANKS}" + ("_bf16" if bf16_wire else "")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=2)
    print(f"[mocha-dryrun] OK m={m} d={d} wire="
          f"{'bf16' if bf16_wire else 'f32'} "
          f"all-gather={coll['all-gather']:.7g}B ({coll['count']} calls) "
          f"arguments={whole / 1e6:.1f}MB (block {block / 1e6:.1f}MB) temp="
          + ("null" if memory["temp_bytes"] is None
             else f"{memory['temp_bytes'] / 1e6:.1f}MB")
          + f" probe={record['probe_s']:.1f}s", flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=512,
                    help="tasks (padded to the data-axis size)")
    ap.add_argument("--n", type=int, default=2048, help="local points/task")
    ap.add_argument("--d", type=int, default=561, help="features")
    ap.add_argument("--steps", type=int, default=2048, help="budget cap")
    ap.add_argument("--bf16-wire", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    run(args.m, args.n, args.d, args.steps, args.bf16_wire, args.device,
        args.out)


if __name__ == "__main__":
    main()
