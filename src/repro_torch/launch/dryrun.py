"""Multi-pod dry-run: the JAX package's ``launch/dryrun.py``.

For every (architecture x input shape x mesh) the plan half builds the
step's abstract inputs on ``meta`` (``launch.specs``), places every leaf
on the production mesh (``launch.sharding``), and records what one device
holds:

  * argument bytes, split into params, optimizer, batch and cache, and the
    donated bytes (params and optimizer in training, the cache in
    serving: what the JAX package's step aliases);
  * ``model_flops`` (``launch.roofline``, the step's useful FLOPs over all
    devices) and its share a device;
  * the device's memory (``torch.cuda.get_device_properties``) and whether
    the arguments fit it; ``null`` with ``--device cpu``;
  * ``plan_s``, the seconds the plan took.

With ``--costs`` the compiler's half is filled in, which the JAX package
reads from XLA's compiled step, by the cost probe (``launch.probe``: the
step run as rank 0 of a fake process group of the mesh's size, each probe
a process of its own), as full-depth sums a device
(``roofline.measure_full_depth``'s depth difference; the JAX package's
figures are of its scanned step, a layer counted once):

  * ``flops_device`` for JAX's ``cost.flops`` (torch's ``flop_registry``
    on the step's local operations, attention as its plain route);
  * ``bytes_device`` for JAX's ``cost.bytes_accessed`` (every eager
    operation's input and output bytes, unfused);
  * ``collectives`` for JAX's ``collectives`` (``hlo_stats``' keys,
    DTensor's collectives by result bytes);
  * ``temp_bytes`` for JAX's ``memory.temp_bytes``: the card's only, the
    step on rank 0's real shards on the card at two depths
    (``temp_depths``; the peak above the arguments), differenced to full
    depth, one case's card probe at a time; ``null`` with
    ``temp_bytes_reason`` under ``--device cpu``.  A case whose probe
    fails, running out of the card's memory included, is recorded with
    ``status`` "error" and the error.

Records land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
      --shape train_4k --costs --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --costs --jobs 3
Without ``--device`` it runs against the card's memory, and raises where
there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline, sharding as sh
from repro_torch.launch.mesh import MeshSpec, make_production_mesh, mesh_name
from repro_torch.launch.roofline import model_flops, param_counts
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import tick

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: the parts of each kind's arguments, in ``build_case``'s ``args`` order
PARTS = {"train": ("params", "optimizer", "batch"),
         "prefill": ("params", "batch", "cache"),
         "decode": ("params", "batch", "cache")}
DONATED = {"train": ("params", "optimizer"), "prefill": ("cache",),
           "decode": ("cache",)}
NOTE = ("temp_bytes, flops_device, bytes_device and collectives are the "
        "cost probe's: not measured in a plan-only run (--costs measures "
        "them)")
#: the four fields the cost probe fills
COST_FIELDS = ("temp_bytes", "flops_device", "bytes_device", "collectives")
CPU_TEMP = ("the card's only: the step's temporary bytes are read from the "
            "card's allocator, and this run is --device cpu")
GIB = 2 ** 30


def plan_bytes(case: dict, mesh: MeshSpec) -> Dict[str, int]:
    """Per-device bytes of a case's arguments by part."""
    out = dict.fromkeys(("params", "optimizer", "batch", "cache"), 0)
    for part, tree, specs in zip(PARTS[case["kind"]], case["args"],
                                 case["in_specs"]):
        out[part] = sh.shard_bytes(tree, specs, mesh)
    return out


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's memory; ``None`` on the CPU, which a plan is not held
    against."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return None


#: one card probe at a time: probes side by side would share the card's
#: memory, and one could run out of it for another's sake
_CARD = threading.Lock()


def temp_depths(cfg) -> Tuple[int, int]:
    """The two depths the temp bytes are differenced between:
    ``roofline._depths``' second and one step of it further, (2, 3) or,
    for zamba2, (12, 18) layers.  A step's peak at the first of
    ``_depths`` falls elsewhere in the step than at every deeper one (on
    an NVIDIA H100 80GB HBM3, smollm-360m train_4k grows by 0.128 GiB from
    1 to 2 layers
    and by 0.191-0.197 GiB a layer from 2 to 32; zamba2-7b prefill_32k by
    0.85 GiB from 6 to 12 layers and by nothing from 12 to 18), while the
    FLOPs, bytes and collectives, counts of the same operations a layer,
    difference exactly from the first."""
    l1, l2 = roofline._depths(cfg)
    return l2, 2 * l2 - l1


def card_depths(cfg) -> List[int]:
    """The depths the card probe runs: ``roofline._depths``' first (which
    warms the process, and whose collectives the CPU probe has too), then
    ``temp_depths``."""
    return [roofline._depths(cfg)[0], *temp_depths(cfg)]


def temp_from_depths(cfg, depths: Dict[str, dict]) -> Dict:
    """The full-depth temp bytes from the card probe's readings at
    ``temp_depths``, differenced as the costs are; ``temp_bytes`` is
    ``None`` and ``error`` says why where a depth failed."""
    l1, l2 = temp_depths(cfg)
    d1, d2 = depths[str(l1)], depths[str(l2)]
    bad = [f"L{n}: {d['error']}" for n, d in ((l1, d1), (l2, d2))
           if d["status"] != "ok"]
    if bad:
        return {"temp_bytes": None, "error": "; ".join(bad)}
    return roofline._difference({"temp_bytes": d1["temp_bytes"]},
                                {"temp_bytes": d2["temp_bytes"]}, l1, l2,
                                cfg.n_layers)


def temp_full_depth(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """The step's temporary bytes on the card at full depth: the card
    probe (``probe.card_memory``) at ``card_depths``, in a process of its
    own, one case at a time (``_CARD``); ``temp_from_depths``' result and
    the probe's readings (``probe``)."""
    from repro_torch.launch import probe
    from repro_torch.launch.specs import resolve_arch_for_shape
    cfg, _ = resolve_arch_for_shape(arch, shape_name)
    with _CARD:
        got = probe.spawn("card_memory",
                          cases=[[arch, shape_name, card_depths(cfg)]],
                          multi_pod=multi_pod)
    return dict(temp_from_depths(cfg, got["cases"][0]["depths"]), probe=got)


def run_case(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             device: Optional[str] = None, costs: bool = False) -> dict:
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a dry-run runs against cuda or cpu, not {dev}")
    name = mesh_name(multi_pod)
    tag = f"{arch}__{shape_name}__{name}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    from repro_torch.launch.specs import build_case
    record = {"arch": arch, "shape": shape_name, "mesh": name,
              "device": dev.type, "status": "error"}
    t0 = tick()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        case = build_case(arch, shape_name, mesh)
        parts = plan_bytes(case, mesh)
        t_plan = tick()
        kind, cfg = case["kind"], case["cfg"]
        argument = sum(parts.values())
        memory = device_memory_bytes(dev)
        total, active = param_counts(cfg)
        flops = model_flops(cfg, shape_name)
        record.update(
            status="ok", kind=kind, swa_variant=case["variant"],
            mesh_axes=list(mesh.axis_names), mesh_shape=list(mesh.shape),
            batch_axes=list(case["batch_axes"]),
            plan_s=t_plan - t0,
            memory={"argument_bytes": argument,
                    **{f"{p}_bytes": n for p, n in parts.items()},
                    "donated_bytes": sum(parts[p] for p in DONATED[kind])},
            device_memory_bytes=memory,
            fits_arguments=None if memory is None else argument <= memory,
            param_counts={"total": total, "active": active},
            model_flops=flops, model_flops_per_device=flops / mesh.size,
            **dict.fromkeys(COST_FIELDS), note=NOTE)
        print(f"[dryrun] OK  {tag}  arg={argument / GIB:.3f} GiB "
              + " ".join(f"{p}={n / GIB:.3f}" for p, n in parts.items())
              + f" fits={record['fits_arguments']}", flush=True)
        if costs:
            del record["note"]
            _fill_costs(record, arch, shape_name, multi_pod, mesh, dev)
    except Exception as e:  # noqa: BLE001 -- record and continue the matrix
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[-4000:]
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {tag}: {record['error'].splitlines()[0][:300]}",
              flush=True)
    record["total_s"] = tick() - t0
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def _fill_costs(record: dict, arch: str, shape_name: str, multi_pod: bool,
                mesh: MeshSpec, dev: torch.device) -> None:
    """The cost probe's fields of ``record`` (module docstring); raises
    where the FLOPs probe fails, records a failed temp probe."""
    t0 = tick()
    with ThreadPoolExecutor(1) as pool:
        # the card's probe beside the CPU's
        temp = (pool.submit(temp_full_depth, arch, shape_name, multi_pod)
                if dev.type == "cuda" else None)
        costs = roofline.measure_full_depth(arch, shape_name, mesh)
        temp = temp and temp.result()
    record.update(flops_device=costs["flops"], bytes_device=costs["bytes"],
                  collectives=costs["collectives"],
                  cost_probes=costs["probes"], costs_s=tick() - t0)
    if temp is None:
        record["temp_bytes_reason"] = CPU_TEMP
    else:
        record.update(temp_bytes=temp["temp_bytes"],
                      temp_probe=temp["probe"])
        if temp["temp_bytes"] is None:
            record.update(status="error", error=f"temp probe: "
                          f"{temp['error']}")
    temp = record["temp_bytes"]
    print(f"[dryrun] costs {arch}__{shape_name}__{record['mesh']}: "
          f"flops/device {costs['flops']:.4g} bytes/device "
          f"{costs['bytes']:.4g} collectives "
          f"{costs['collectives']['total']:.4g} B "
          f"({costs['collectives']['count']:.0f}) temp "
          + ("null" if temp is None else f"{temp / GIB:.3f} GiB")
          + f" ({record['costs_s']:.1f} s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card's memory) or cpu")
    ap.add_argument("--costs", action="store_true",
                    help="run the cost probe: FLOPs, bytes and collectives "
                    "a device, and on the card the step's temp bytes")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases run at once")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:        # every arch, at --shape where it is given
        cases = [(a, s) for a in ALL_ARCHS
                 for s in ([args.shape] if args.shape else SHAPES)]
    elif args.arch and args.shape:
        cases = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    def one(item):
        multi_pod, (arch, shape) = item
        return run_case(arch, shape, multi_pod, args.out, args.force,
                        device=args.device, costs=args.costs)

    with ThreadPoolExecutor(args.jobs) as pool:
        records = list(pool.map(one, [(mp, c) for mp in meshes
                                      for c in cases]))
    failures = sum(rec["status"] != "ok" for rec in records)
    print(f"[dryrun] done, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
