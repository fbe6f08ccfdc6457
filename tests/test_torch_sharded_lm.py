"""``repro_torch.examples.sharded_lm``, the SPMD example of the sharded LM
step, on four gloo ranks on the CPU under ``torch.distributed.run``.

The whole example with ``--local`` (the reduced smollm-360m, granite-moe,
rwkv6 and zamba2 configs, their layers stacked as at full size): rank 0's
one-device runs, then the same runs on a 2 x 2 mesh inside
``gloo_collectives``, held here to the mesh-step limits (PERF.md §2):
f32 ce and grad_norm rtol 1e-5, bf16 ce 5e-4, logits 1e-4 / 5e-2 x max(1,
max |logit|) with f32 tokens equal, bf16 MoE on the one-device run's
experts, every cache and state leaf in the plan's placements at each of
``new`` + 2 checks, no decode step gathering a shard (a rank raises
otherwise); the mesh-only rwkv6 step's ce equal on every rank and each
rank's parameter and optimizer bytes exactly ``launch.dryrun``'s plan a
device plus what the port documents holding beyond it.  Then the example's
refusals and faults: a world size other than the mesh's raises; the
example enters ``gloo_collectives`` on a gloo group only, never where the
group's CUDA backend is NCCL; a rank that raises, and a rank whose cache
leaf is moved off its placement, make the launcher exit non-zero well
inside the group's timeout.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.examples import sharded_lm as S

ROOT = Path(__file__).resolve().parents[1]
#: the launcher's wall limit for the whole example, and for a fault drill
RUN_LIMIT_S = 300
DRILL_LIMIT_S = 120
#: the group's timeout in the drills: a rank left in a collective gives up
DRILL_TIMEOUT_S = 90


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _launch(tmp_path, script, args, nproc=4, limit=RUN_LIMIT_S):
    """``script`` (a module name, or a file) under ``torch.distributed.run``
    with ``nproc`` ranks (``--standalone``: a free port on this host);
    (return code, output, seconds)."""
    target = ["-m", script] if not script.endswith(".py") else [script]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--monitor_interval", "0.5",
           *target, *args]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, env=_env(), cwd=tmp_path, capture_output=True,
                          text=True, timeout=limit)
    return proc.returncode, proc.stdout + proc.stderr, time.monotonic() - t0


def _report(text):
    lines = [line for line in text.splitlines()
             if line.startswith('{"sharded_lm"')]
    assert len(lines) == 1, text[-4000:]
    return json.loads(lines[0])["sharded_lm"]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    rc, text, _ = _launch(tmp_path_factory.mktemp("example"),
                          "repro_torch.examples.sharded_lm",
                          ["--device", "cpu", "--local"])
    assert rc == 0, text[-4000:]
    return _report(text)


TRAIN = [(a, str(dt)[6:]) for a, _, dt, _ in S.TRAIN]
GEN = [(a, str(dt)[6:]) for a, _, _, _, dt in S.gen_runs(S.GEN)]


def _row(rows, arch, dtype):
    hits = [r for r in rows if r["arch"] == arch and r["dtype"] == dtype]
    assert len(hits) == 1, (arch, dtype, rows)
    return hits[0]


def test_example_runs_on_a_gloo_mesh(report):
    assert report["ok"] and report["ranks"] == 4 and report["local"]
    assert report["backend"] == "cpu:gloo,cuda:gloo"
    assert report["gloo_collectives"] is True
    assert len(report["train"]) == len(TRAIN)
    assert len(report["generate"]) == len(GEN)
    # the CPU's wrappers run their plain versions and count no launch
    assert report["launches"] == {"flash_attention": 0,
                                  "decode_attention": 0,
                                  "cache_attention": 0}


@pytest.mark.parametrize("arch,dtype", TRAIN)
def test_train_matches_one_device(report, arch, dtype):
    r = _row(report["train"], arch, dtype)
    limit = S.TRAIN_RTOL[getattr(torch, dtype)]
    assert r["rel_err"]["ce"] <= limit, r
    if dtype == "float32":
        assert r["rel_err"]["grad_norm"] <= limit, r
    assert len(r["ce"]) == S.STEPS and r["collectives"]
    want = ["data", "model"] if r["batch"] == 4 else ["data"]
    assert r["batch_axes"] == want
    if arch.startswith("granite-moe"):    # each rank's tokens counted
        assert len(r["routing_flips"]) == 4
        assert all(int(f.split("/")[1]) > 0 for f in r["routing_flips"])


@pytest.mark.parametrize("arch,dtype", GEN)
def test_generate_matches_one_device(report, arch, dtype):
    r = _row(report["generate"], arch, dtype)
    assert r["logit_err"] <= S.LOGIT_TOL[getattr(torch, dtype)], r
    assert r["tokens_equal"] or dtype == "bfloat16"
    assert len(r["logit_err_steps"]) == r["new"] == S.LOCAL["new"]
    assert r["placement_checks"] == r["new"] + 2
    assert sum(r["decode_collectives"].values()) > 0
    if arch != "rwkv6-7b":          # an attention cache, T over 'model'
        assert r["cache_slots"][1] * 2 == r["cache_slots"][0]


def test_rows_name_the_limit_that_held_them(report):
    """rwkv6's rows carry their floor (three perturbed one-device runs);
    at the reduced size it is under PERF.md §2's limit, which holds them,
    as it holds every other row."""
    for r in report["train"] + report["generate"] + report["segments"]:
        if r["arch"] in S.FLOOR_ARCHS:
            assert r["floor"] is not None and r["floor"] > 0, r
            assert r["floor"] <= r["limit"]
        else:
            assert r["floor"] is None
        assert r["held_by"] == "PERF.md §2"
    assert report["floor_seeds"] == list(S.FLOOR_SEEDS)


@pytest.mark.parametrize("fault", list(S.PLANTS))
def test_planted_faults_miss_the_rows_limit(report, fault):
    """rank 1's wkv state scaled by 1 + 1e-3, or its token-shift x_prev
    zeroed, after the f32 rwkv6 generate's prefill: the run misses the
    limit that holds the fault-free row."""
    (r,) = [r for r in report["planted"] if r["fault"] == fault]
    row = _row(report["generate"], "rwkv6-7b", "float32")
    assert r["caught"] and r["limit"] == row["limit"] < r["logit_err"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_prefill_matches_one_device(report, dtype):
    """The prompt in four prefill calls on one cache (the later three
    through the cache attention path, each rank on its T-slice): every
    call's and decode step's logits within the LM limits, f32 tokens
    equal, the cache's placements checked after each call."""
    r = _row(report["segments"], "smollm-360m", dtype)
    assert r["segments"] == 4
    assert r["logit_err"] <= S.LOGIT_TOL[getattr(torch, dtype)], r
    assert len(r["logit_err_steps"]) == r["new"] + 3
    assert r["placement_checks"] == r["new"] + 5
    assert r["tokens_equal"] or dtype == "bfloat16"
    assert r["cache_slots"][1] * 2 == r["cache_slots"][0]


def test_mesh_only_step_holds_the_plans_bytes(report):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import build_case_from_cfg
    (r,) = report["mesh_only"]
    assert r["arch"] == "rwkv6-7b" and r["dtype"] == "bfloat16"
    assert all(ce == r["ce"] for ce in r["ce_by_rank"])
    assert all(torch.isfinite(torch.tensor(r["ce"])))
    mesh = make_test_mesh(2, 2)
    plan = dryrun.plan_bytes(build_case_from_cfg(
        S.local_cfg("rwkv6-7b"), "train_4k", mesh), mesh)
    assert r["plan_state_bytes"] == plan["params"] + plan["optimizer"]
    # the block vectors in f32 where the plan's are bf16 (2 bytes an
    # element more), and no int32 step (4 bytes fewer)
    assert r["port_extra_bytes"] > 0 and (r["port_extra_bytes"] + 4) % 2 == 0
    assert r["state_bytes_by_rank"] == [
        r["plan_state_bytes"] + r["port_extra_bytes"]] * 4


@pytest.mark.parametrize("nproc", [1, 2])
def test_a_world_size_other_than_the_meshs_raises(tmp_path, nproc):
    args = ["--device", "cpu", "--local", "--arch", "smollm-360m"]
    if nproc == 1:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.sharded_lm", *args],
            env=_env(), cwd=tmp_path, capture_output=True, text=True,
            timeout=DRILL_LIMIT_S)
        rc, text = proc.returncode, proc.stdout + proc.stderr
    else:
        rc, text, _ = _launch(tmp_path, "repro_torch.examples.sharded_lm",
                              args, nproc=nproc, limit=DRILL_LIMIT_S)
    assert rc != 0
    assert f"needs 4 ranks; the group has {nproc}" in text


@pytest.mark.parametrize("config,device,routed", [
    ("cpu:gloo,cuda:nccl", "cuda", False),
    ("cpu:gloo,cuda:gloo", "cuda", True),
    ("cpu:gloo,cuda:nccl", "cpu", True),
    ("cpu:gloo,cuda:gloo", "cpu", True),
])
def test_gloo_collectives_on_a_gloo_group_only(monkeypatch, config, device,
                                               routed):
    from repro_torch.utils import dist as dist_utils
    entered = []
    monkeypatch.setattr(torch.distributed, "get_backend_config",
                        lambda group=None: config)
    monkeypatch.setattr(dist_utils, "gloo_collectives",
                        lambda: entered.append(1) or
                        __import__("contextlib").nullcontext())
    with S.collectives_for(torch.device(device)):
        pass
    assert S.through_gloo(torch.device(device)) is routed
    assert entered == ([1] if routed else [])


def test_a_group_without_the_devices_backend_is_refused(monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_backend_config",
                        lambda group=None: "cuda:nccl")
    with pytest.raises(RuntimeError, match="carries no cpu tensors"):
        S.through_gloo(torch.device("cpu"))


_DRILL = r'''
import os, sys
from repro_torch.examples import sharded_lm as S
from repro_torch.launch import sharding as sh
rank, fault = int(os.environ["RANK"]), sys.argv.pop(1)
S.TIMEOUT_S = float(sys.argv.pop(1))

if fault == "raise" and rank == 2:
    train = S.mesh_train_run

    def mesh_train_run(*args, **kwargs):
        if len(args) > 5 and args[5] is not None:          # on the mesh
            raise RuntimeError("planted: rank 2 fails its mesh step")
        return train(*args, **kwargs)

    S.mesh_train_run = mesh_train_run

if fault == "misplace" and rank == 1:
    from torch.distributed.tensor import DTensor, Replicate
    distribute = sh.distribute

    def moved(tree, specs, mesh, dm):
        out = distribute(tree, specs, mesh, dm)
        if isinstance(out, dict) and "pos" in out:          # a cache
            layer = out["blocks"][0]
            k = layer["k"]
            layer["k"] = DTensor.from_local(k.to_local(), dm,
                                            [Replicate()] * dm.ndim,
                                            run_check=False)
        return out

    sh.distribute = moved

S.main()
'''


@pytest.mark.parametrize("fault,rank,message", [
    ("raise", 2, "planted: rank 2 fails its mesh step"),
    ("misplace", 1, "rank 1: smollm-360m-reduced float32 before prefill: "
                    "cache or state leaves off the plan's placements"),
])
def test_a_planted_fault_stops_every_rank(tmp_path, fault, rank, message):
    """A rank that raises, or whose first layer's k cache is placed
    Replicate on rank 1 alone, makes the launcher stop the others and exit
    non-zero, in far less than the group's timeout, with no JSON line."""
    drill = tmp_path / "drill.py"
    drill.write_text(_DRILL)
    rc, text, wall = _launch(
        tmp_path, str(drill),
        [fault, str(DRILL_TIMEOUT_S), "--device", "cpu", "--local",
         "--arch", "smollm-360m"], limit=DRILL_LIMIT_S)
    assert rc != 0
    assert message in text, text[-3000:]
    assert '{"sharded_lm"' not in text
    assert wall < DRILL_TIMEOUT_S
