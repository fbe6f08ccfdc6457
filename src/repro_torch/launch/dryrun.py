"""Multi-pod dry-run, its plan half: the JAX package's ``launch/dryrun.py``
without the compiler.

For every (architecture x input shape x mesh) this builds the step's
abstract inputs on ``meta`` (``launch.specs``), places every leaf on the
production mesh (``launch.sharding``), and records what one device holds:

  * argument bytes, split into params, optimizer, batch and cache, and the
    donated bytes (params and optimizer in training, the cache in
    serving: what the JAX package's step aliases);
  * ``model_flops`` (``launch.roofline``, the step's useful FLOPs over all
    devices) and its share a device;
  * the device's memory (``torch.cuda.get_device_properties``) and whether
    the arguments fit it; ``null`` with ``--device cpu``;
  * ``plan_s``, the seconds the plan took.

``temp_bytes``, ``flops_hlo`` and ``collectives`` are the compiler's half
(the JAX package reads them from XLA's compiled step) and stay ``null``
here: ROADMAP.md item 23, a cost probe of the sharded step that
``build_case``'s ``fn`` runs on a mesh (every family).

Records land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      --device cpu
Without ``--device`` it runs against the card's memory, and raises where
there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import sharding as sh
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
NOTE = ("temp_bytes, flops_hlo and collectives are the compiled step's; "
        "not measured until a cost probe of the sharded step is ported "
        "(ROADMAP.md item 23)")
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


def run_case(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             device: Optional[str] = None) -> dict:
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
            temp_bytes=None, flops_hlo=None, collectives=None, note=NOTE)
        print(f"[dryrun] OK  {tag}  arg={argument / GIB:.3f} GiB "
              + " ".join(f"{p}={n / GIB:.3f}" for p, n in parts.items())
              + f" fits={record['fits_arguments']}")
    except Exception as e:  # noqa: BLE001 -- record and continue the matrix
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {tag}: {record['error'][:200]}")
    record["total_s"] = tick() - t0
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


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
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cases = [(a, s) for a in ALL_ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cases = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = 0
    for multi_pod in meshes:
        for arch, shape in cases:
            rec = run_case(arch, shape, multi_pod, args.out, args.force,
                           device=args.device)
            failures += rec["status"] != "ok"
    print(f"[dryrun] done, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
