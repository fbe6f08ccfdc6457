"""The cost probe: ``build_case``'s sharded step run as rank 0 of a fake
process group the size of the production mesh, in a process of its own.

The JAX package compiles a step for 256 or 512 devices on one host and
reads its costs from XLA (``launch/dryrun.py``, ``launch/roofline.py``).
The port runs the step instead, as one rank of the mesh: a fake group
(``utils.dist.fake_group``) gives DTensor every collective at once with a
result of the right shape and nothing written in it, so rank 0's part of
the step runs alone.  Two probes:

  * ``fake_costs`` (the CPU): the step on FakeTensors (shapes, no
    storage) of the CPU's device type, where the attention wrappers run
    their plain versions, the only route that runs without data (as the
    plan half runs on ``meta``).  It runs the step twice and counts the
    second, warm call: per-device FLOPs and bytes
    (``utils.dist.DeviceCost``) and DTensor's collectives
    (``utils.dist.dtensor_collectives``, summed by ``hlo_stats``).
  * ``card_memory`` (the card): the step on real CUDA tensors, the
    arguments allocated as rank 0's shards (zeros, wrapped by
    ``DTensor.from_local``), on the kernel route; its temporary bytes
    (``torch.cuda.max_memory_allocated()`` after
    ``reset_peak_memory_stats()``, less the arguments), its collectives and
    its kernel launches.  The fake group's collectives write nothing, so
    what they return is whatever the allocator hands out: the run reads
    memory and no value.

``spawn`` runs a probe in a fresh Python process: a fake group must never
outlive its probe (``federated.runtime`` makes a group only where none
exists, so a fake one left behind would carry a real run's collectives).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import traceback
from typing import Any, Dict, Iterator, Sequence

import torch

from repro_torch.configs.base import ArchConfig

#: the last line a probe prints, before its result
_MARK = "PROBE-RESULT "


def spawn(target: str, timeout: float = 1200.0, **kwargs) -> Dict[str, Any]:
    """``target`` (a function of this module) called with ``kwargs`` (JSON)
    in a fresh Python process; returns its JSON result.  Raises with the
    end of the child's output where it fails."""
    if target not in ("fake_costs", "card_memory"):
        raise ValueError(f"no probe {target!r}")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    code = ("import json, sys; from repro_torch.launch import probe; "
            f"probe._child({target!r}, json.loads(sys.argv[1]))")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(kwargs)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith(_MARK)]
    if out.returncode != 0 or not lines:
        text = out.stdout + out.stderr
        errors = re.findall(r"^(?:\[rank\d+\]: )?(\w+(?:Error|Exception)\b.*)$",
                            text, re.M)
        raise RuntimeError(f"probe {target} exited {out.returncode}: "
                           f"{errors[-1] if errors else ''}\n{text[-3000:]}")
    return json.loads(lines[-1][len(_MARK):])


def _child(target: str, kwargs: Dict[str, Any]) -> None:
    result = globals()[target](**kwargs)
    print(_MARK + json.dumps(result), flush=True)


def place_shards(tree, specs, mesh, device_mesh, device):
    """``tree`` (abstract leaves) with every tensor leaf a DTensor on
    ``device_mesh`` whose local tensor is rank 0's shard under its spec,
    zeros on ``device`` (FakeTensors under a ``FakeTensorMode``).  The
    optimizer's step, an int32 scalar in the plan, is the port's host int.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as sh

    def leaf(t, s):
        local = torch.zeros(sh.local_shape(t.shape, s, mesh), dtype=t.dtype,
                            device=device)
        return DTensor.from_local(
            local, device_mesh, sh.placements(s, mesh), run_check=False,
            shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            items = [walk(v, sv) for v, sv in zip(t, s)]
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        return leaf(t, s) if torch.is_tensor(t) else t

    return walk(tree, specs)


def step_args(case, mesh, device_mesh, device):
    """``case``'s arguments as rank 0 holds them, ready for ``case["fn"]``:
    in training every float parameter is trainable and the optimizer's
    step is the port's host int."""
    args = [place_shards(t, s, mesh, device_mesh, device)
            for t, s in zip(case["args"], case["in_specs"])]
    if case["kind"] == "train":
        for p in torch.utils._pytree.tree_leaves(args[0]):
            if torch.is_tensor(p) and p.is_floating_point():
                p.requires_grad_(True)
        args[1] = args[1]._replace(step=0)
    return args


@contextlib.contextmanager
def _probe_dtensor() -> Iterator[None]:
    """Two mends of how DTensor runs under the fake CPU probe, neither
    changing what the step computes or sends:

      * the placement arithmetic of a ``_StridedShard`` (a flattened
        operand split over two mesh dims: rwkv6's decay LoRA at
        prefill_32k) reads an index tensor's values to the host, which a
        FakeTensor has not: it runs here on real index tensors, outside
        the fake mode (and outside ``DeviceCost``);
      * on a CPU mesh DTensor moves a shard from one dim to another by an
        all-gather and a chunk (gloo has no all-to-all); on the card it
        calls ``_dtensor.shard_dim_alltoall``.  The probe takes the card's
        path, so it counts the all-to-all the card sends."""
    from torch.distributed.tensor import placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes
    saved = []
    strided = getattr(pt, "_StridedShard", None)
    if strided is not None and hasattr(strided,
                                       "local_shard_size_and_offset"):
        orig = strided.local_shard_size_and_offset

        def local_shard_size_and_offset(self, *args, **kwargs):
            with _disable_current_modes():
                return orig(self, *args, **kwargs)

        saved.append((strided, "local_shard_size_and_offset", orig))
        strided.local_shard_size_and_offset = local_shard_size_and_offset
    if hasattr(pt, "shard_dim_alltoall"):
        from torch.distributed._functional_collectives import (
            _resolve_group_name)

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                _resolve_group_name((mesh, mesh_dim)))

        saved.append((pt, "shard_dim_alltoall", pt.shard_dim_alltoall))
        pt.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _calls(calls) -> list:
    """DTensor's recorded collectives as (kind, result bytes) pairs."""
    from repro_torch.launch import hlo_stats
    return [[hlo_stats._kind(c.name), hlo_stats.result_bytes(c)]
            for c in calls if hlo_stats._kind(c.name) is not None]


def _case(cfg: Dict[str, Any], shape: str, multi_pod: bool):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_case_from_cfg
    mesh = make_production_mesh(multi_pod=multi_pod)
    return mesh, build_case_from_cfg(ArchConfig(**cfg), shape, mesh)


def fake_costs(cfg: Dict[str, Any], shape: str, multi_pod: bool = False
               ) -> Dict[str, Any]:
    """Per-device costs of one config's step, counted on its second call
    on FakeTensors (module docstring): ``flops``, ``bytes``, ``coll`` and
    ``coll_raw`` (collective result bytes; equal, see ``hlo_stats``), the
    per-kind ``collectives``, each call as (kind, bytes), the operations
    counted and the two calls' seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.utils.dist import (DeviceCost, dtensor_collectives,
                                        fake_group)
    from repro_torch.utils.pjit_utils import activation_sharding
    from repro_torch.utils.timing import tick
    torch.set_num_threads(1)
    mesh, case = _case(cfg, shape, multi_pod)
    with fake_group(mesh.size), _probe_dtensor():
        dm = device_mesh(mesh, device="cpu")
        seconds = []
        for warm in (False, True):
            with FakeTensorMode():
                args = step_args(case, mesh, dm, "cpu")
                t0 = tick()
                with activation_sharding(mesh, case["batch_axes"], dm), \
                        dtensor_collectives() as (_, calls), \
                        (DeviceCost() if warm else
                         contextlib.nullcontext()) as cost:
                    case["fn"](*args)
                seconds.append(tick() - t0)
    coll = hlo_stats.collective_bytes(calls)
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "coll": float(coll["total_bf16_equiv"]),
            "coll_raw": float(coll["total"]), "collectives": coll,
            "calls": _calls(calls), "ops": cost.ops,
            "cold_s": seconds[0], "warm_s": seconds[1]}


def card_memory(cases: Sequence[Sequence], multi_pod: bool = False
                ) -> Dict[str, Any]:
    """Each case, (arch, shape, depths), its step at each of ``depths``
    (layers; the rest of the config as ``roofline._shallow`` leaves it) on
    the card, one after another in this process (module docstring).  For
    each depth: ``argument_bytes`` (the allocator's, for rank 0's shards),
    ``temp_bytes`` (the step's peak above them), the collectives as
    ``fake_costs`` gives them, the attention kernels' launches and the
    step's seconds; or ``status`` "error" and the error, a depth that runs
    out of the card's memory included.  The process's first step's peak
    also holds what the process allocates once (cuBLAS's workspace, 32
    MiB): let it be a depth that no temp bytes are read from."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.roofline import _shallow
    from repro_torch.launch.specs import resolve_arch_for_shape
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.dist import dtensor_collectives, fake_group
    from repro_torch.utils.pjit_utils import activation_sharding
    from repro_torch.utils.timing import tick
    dev = resolve_device("cuda")
    out: Dict[str, Any] = {"device": torch.cuda.get_device_name(dev),
                           "torch": torch.__version__, "cases": []}
    with fake_group(256 * (2 if multi_pod else 1)):
        for arch, shape, depths in cases:
            full, _ = resolve_arch_for_shape(arch, shape)
            got: Dict[str, Any] = {}
            for depth in depths:
                cfg = dataclasses.asdict(_shallow(full, depth))
                mesh, case = _case(cfg, shape, multi_pod)
                dm = device_mesh(mesh, device="cuda")
                rec: Dict[str, Any] = {"status": "error"}
                try:
                    torch.cuda.empty_cache()
                    base = torch.cuda.memory_allocated(dev)
                    args = step_args(case, mesh, dm, dev)
                    held = torch.cuda.memory_allocated(dev) - base
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    FA.reset_counts()
                    DA.reset_counts()
                    t0 = tick()
                    with activation_sharding(mesh, case["batch_axes"], dm), \
                            dtensor_collectives() as (_, calls):
                        result = case["fn"](*args)
                        torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated(dev) - base
                    rec.update(status="ok", step_s=tick() - t0,
                               argument_bytes=held, peak_bytes=peak,
                               temp_bytes=peak - held,
                               collectives=hlo_stats.collective_bytes(calls),
                               calls=_calls(calls),
                               launches={**FA.COUNTS, **DA.COUNTS})
                except torch.cuda.OutOfMemoryError as e:
                    where = [f"{os.path.basename(f.filename)}:{f.lineno}"
                             for f in traceback.extract_tb(e.__traceback__)
                             if "repro_torch" in f.filename][-4:]
                    rec["error"] = (f"OutOfMemoryError in "
                                    f"{' > '.join(where)}: {str(e)[:240]}")
                finally:
                    args = result = None
                got[str(depth)] = rec
            out["cases"].append({"arch": arch, "shape": shape,
                                 "depths": got})
    return out
