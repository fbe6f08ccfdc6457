"""The dry-run's compiler half in the port (``launch/hlo_stats``, the
measured half of ``launch/roofline``, ``launch/mocha_dryrun``, the cost
probe of ``launch/probe`` and ``utils.dist.DeviceCost``) against the JAX
package's, on the CPU.

Every probe runs in a spawned process: a fake process group must not be
left in a pytest worker.  ``repro.launch.roofline`` is imported with
``XLA_FLAGS`` put back as it was (it sets the flag when imported);
``repro.launch.mocha_dryrun`` sets it unconditionally and runs only in a
subprocess of its own.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.archs import ALL_ARCHS as JAX_ARCHS
from repro.launch import hlo_stats as jhlo
from repro.launch.specs import resolve_arch_for_shape as jresolve
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import hlo_stats, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import resolve_arch_for_shape
from repro_torch.utils.dist import Collective, DTensorCollective

_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as jroofline  # noqa: E402
if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

ROOT = Path(__file__).resolve().parents[1]
#: the JAX package's shim of the root conftest.py, for a subprocess that
#: imports ``repro`` outside pytest
_SHIM = """
from jax._src.interpreters import batching as _b
_p = type(_b.primitive_batchers)
if not hasattr(_p, "setdefault"):
    _p.setdefault = lambda self, key, value: value
"""


def _run(code: str, *args, timeout: float = 300) -> str:
    """``code`` in a fresh Python (the package on its path, no card), its
    standard output; fails the test with the child's output where it
    fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=str(ROOT))
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout


# -- (a) collective bytes against JAX's HLO parser -----------------------------

#: (kind, dtype, result shape or shapes): tests/test_launch.py::
#: test_collective_parser's three (an all-gather-start of two results
#: among them) and one of each other kind and dtype
_CALLS = [
    ("all-reduce", torch.float32, (512, 1024)),
    ("all-gather", torch.bfloat16, (8, 256)),
    ("all-gather", torch.float32, ((4,), (8,))),
    ("reduce-scatter", torch.bfloat16, (16, 4096)),
    ("all-to-all", torch.int32, (3, 5, 7)),
    ("collective-permute", torch.float16, (64,)),
    ("all-reduce", torch.int64, ()),
    ("all-gather", torch.uint8, (9, 2)),
    ("reduce-scatter", torch.bool, (33,)),
    ("all-to-all", torch.float64, (2, 2)),
]
#: the name each kind is recorded under: torch.distributed's, DTensor's
_NAMES = {"all-reduce": ("all_reduce", "all_reduce"),
          "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor"),
          "reduce-scatter": ("reduce_scatter_tensor", "reduce_scatter_tensor"),
          "all-to-all": ("all_to_all_single", "shard_dim_alltoall"),
          "collective-permute": ("send", "send")}


def _hlo_type(dtype, shape) -> str:
    name = hlo_stats.DTYPE_NAMES[dtype]
    if shape and isinstance(shape[0], tuple):
        return "(" + ", ".join(_hlo_type(dtype, s) for s in shape) + ")"
    return f"{name}[{','.join(map(str, shape))}]{{0}}"


def _hlo(calls) -> str:
    lines = []
    for i, (kind, dtype, shape) in enumerate(calls):
        start = "-start" if shape and isinstance(shape[0], tuple) else ""
        lines.append(f"  %c.{i} = {_hlo_type(dtype, shape)} "
                     f"{kind}{start}(%x.{i}), replica_groups={{}}")
    lines.append("  %other = f32[2,2]{1,0} add(%p, %q)")
    return "\n".join(lines)


@pytest.mark.parametrize("recorder", ["counted", "dtensor"])
def test_collective_bytes_match_jax_parser(recorder):
    want = jhlo.collective_bytes(_hlo(_CALLS))
    if recorder == "counted":
        calls = [Collective(_NAMES[k][0], s, dt) for k, dt, s in _CALLS]
    else:
        calls = [DTensorCollective(_NAMES[k][1], (1,), dt, None, s)
                 for k, dt, s in _CALLS]
    got = hlo_stats.collective_bytes(calls)
    for key in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "count", "total"):
        assert got[key] == want[key], key
    assert want["count"] == len(_CALLS)
    # eager torch sends each tensor in its own dtype: nothing to correct
    assert got["total_bf16_equiv"] == got["total"]


def test_dtype_table_matches_jax():
    for dtype, name in hlo_stats.DTYPE_NAMES.items():
        assert hlo_stats._DTYPE_BYTES[name] == jhlo._DTYPE_BYTES[name]
        assert torch.empty((), dtype=dtype).element_size() == \
            jhlo._DTYPE_BYTES[name], name
    assert set(hlo_stats._DTYPE_BYTES) == set(jhlo._DTYPE_BYTES)


def test_uncounted_and_unknown_collectives():
    """A barrier or broadcast has no HLO collective: not counted; a name
    with no kind raises rather than being dropped."""
    calls = [Collective("barrier", (), None),
             Collective("broadcast", (4,), torch.float32),
             Collective("all_gather_single", (4, 3), torch.float32)]
    out = hlo_stats.collective_bytes(calls)
    assert out["count"] == 1 and out["all-gather"] == 48
    with pytest.raises(ValueError, match="no HLO kind"):
        hlo_stats.collective_bytes([Collective("frobnicate", (1,),
                                               torch.float32)])


# -- (b) the per-device counter on a fake 16 x 16 group -------------------------

_COUNTER = r'''
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import device_mesh, make_production_mesh
from repro_torch.utils.dist import DeviceCost, dtensor_collectives, fake_group
mesh = make_production_mesh()
out = {}
with fake_group(mesh.size):
    dm = device_mesh(mesh, device="cpu")
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(4096, 1024), dm,
                              [Shard(0), Shard(1)], src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 4096), dm,
                              [Replicate(), Shard(0)], src_data_rank=None)
        flops = []
        for _ in range(2):
            with DeviceCost() as cost, dtensor_collectives() as (_, calls):
                y = a @ b
            flops.append(cost.flops)
        out["product"] = flops
        out["local"] = list(y.to_local().shape)
        out["calls"] = len(calls)
        x = torch.empty(64, 32)
        w = torch.empty(32, 16)
        with DeviceCost() as cost:
            x @ w
            v = x.t()
            x + x
        out["replicated"] = [cost.flops, cost.bytes, cost.ops]
print("RESULT " + json.dumps(out))
'''


def test_device_cost_counts_a_rank_s_local_work():
    """The (4096, 1024) @ (1024, 4096) product, split [S(0), S(1)] by
    [R, S(0)] over a fake 16 x 16 group, is a (256, 64) @ (64, 4096)
    product on each rank: 2 * 256 * 1024 * 256 FLOPs on a warm call,
    while the first call also counts DTensor's sharding propagation at
    the global shape.  A product of plain tensors counts in full; a view
    adds no bytes, an add its three operands'."""
    line = [ln for ln in _run(_COUNTER).splitlines()
            if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    cold, warm = got["product"]
    assert warm == 2 * 256 * 1024 * 256
    assert cold > warm
    assert got["local"] == [256, 4096] and got["calls"] == 0
    flops, nbytes, ops = got["replicated"]
    assert flops == 2 * 64 * 32 * 16
    assert nbytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 + 3 * 64 * 32 * 4
    assert ops == 3


# -- (c) depth differencing and the roofline terms against JAX's ---------------

def _synthetic(cfg, shape_name, mesh):
    """Costs linear in depth, per key its own fixed and per-layer parts."""
    n = cfg.n_layers
    return {"flops": 3.0e12 + 1.25e11 * n, "bytes": 7.0e9 + 2.5e8 * n,
            "coll": 1.0e6 + 4096.0 * n, "coll_raw": 2.0e6 + 8192.0 * n}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_measure_full_depth_matches_jax(monkeypatch, shape):
    monkeypatch.setattr(jroofline, "_measure", _synthetic)
    monkeypatch.setattr(roofline, "_measure", _synthetic)
    for arch in ALL_ARCHS:
        want = jroofline.measure_full_depth(arch, shape, mesh=object())
        got = roofline.measure_full_depth(arch, shape,
                                          mesh=make_production_mesh())
        assert got == want, arch


def test_depths_and_shallow_match_jax():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            cfg, variant = resolve_arch_for_shape(arch, shape)
            jcfg, jvariant = jresolve(arch, shape)
            assert variant == jvariant
            assert roofline._depths(cfg) == jroofline._depths(jcfg)
            for n in roofline._depths(cfg):
                got, want = roofline._shallow(cfg, n), jroofline._shallow(
                    jcfg, n)
                for f in ("n_layers", "scan_layers", "name",
                          "sliding_window", "shared_attn_period"):
                    assert getattr(got, f) == getattr(want, f), (arch, f)


def test_roofline_terms_match_jax(monkeypatch):
    """JAX's terms with JAX's constants patched to the H100's; the port
    calls JAX's ``hlo_flops_global`` ``flops_global`` (no HLO here)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "CHIPS"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    assert roofline.CHIPS == 256
    costs = [{"flops": 1.7e13, "bytes": 1.0e12, "coll": 9.6e8},
             {"flops": 9.3e10, "bytes": 5.3e11, "coll": 8.4e7},
             {"flops": 1.0e9, "bytes": 1.0e6, "coll": 3.2e11}]
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            for c in costs:
                got = roofline.roofline_terms(arch, shape, c)
                want = jroofline.roofline_terms(arch, shape, c)
                want["flops_global"] = want.pop("hlo_flops_global")
                assert got == want, (arch, shape)


# -- (d) one step, measured ------------------------------------------------------

def test_smollm_train_step_measured_on_a_fake_pod():
    """smollm-360m train_4k at its published widths, depths 1 and 2, each
    as rank 0 of a fake 256-rank group.  Every rank holds one sequence of
    4096 tokens (batch over data x model), so the counted FLOPs are the
    6 N D of its tokens (every matrix product forward and backward), the
    blocks' recompute (``cfg.remat``: each block's forward runs again in
    the backward, up to the last tensor it saves, so every matrix product
    of a block but its MLP's down projection, whose output is saved by
    nothing: 2 (N_blocks - L d d_ff) D), plus attention as its plain
    route computes it: the whole S x S score matrix, forward (Q K^T and
    P V, 4 S d_attn a token), once more in the block's recompute, then
    recomputed in flash's backward and differentiated (12 S d_attn more):
    20 S d_attn a token a layer.  The useful ratio is then 6 N D /
    (6 N D + 2 (N_blocks - L d d_ff) D + 20 L S d_attn D), 0.421 (0.519
    before the recompute), held within 2% (the norms and the loss add no
    products)."""
    costs = roofline.measure_full_depth("smollm-360m", "train_4k")
    p1, p2 = costs["probes"]["1"], costs["probes"]["2"]
    for p in (p1, p2):
        assert p["collectives"]["count"] > 0 and p["coll"] > 0
        assert p["collectives"]["all-gather"] > 0
        assert math.isfinite(p["flops"]) and p["flops"] > 0
        assert p["bytes"] > 0
    assert p2["flops"] > p1["flops"]
    assert costs["flops"] > 0 and costs["coll"] > 0
    assert costs["coll"] == costs["coll_raw"]
    assert costs["collectives"]["total"] == costs["coll"]
    cfg, _ = resolve_arch_for_shape("smollm-360m", "train_4k")
    assert cfg.remat and cfg.tie_embeddings
    terms = roofline.roofline_terms("smollm-360m", "train_4k", costs)
    tokens = 4096                      # one sequence a device
    model = terms["model_flops"] / roofline.CHIPS
    blocks = (roofline.param_counts(cfg)[1]
              - cfg.vocab_size * cfg.d_model) * tokens
    recompute = 2 * (blocks - cfg.n_layers * cfg.d_model * cfg.d_ff * tokens)
    attention = 20 * cfg.n_layers * 4096 * cfg.attn_dim * tokens
    expected = model / (model + recompute + attention)
    assert abs(terms["useful_ratio"] - expected) <= 0.02 * expected, (
        terms["useful_ratio"], expected)


# -- (e) the MOCHA round against JAX's record -----------------------------------

_PORT_MOCHA = r'''
import sys
from repro_torch.launch import mocha_dryrun
for wire in ([], ["--bf16-wire"]):
    mocha_dryrun.main(["--m", "256", "--n", "4", "--d", "3", "--steps", "4",
                       "--device", "cpu", "--out", sys.argv[1]] + wire)
'''

_JAX_MOCHA = _SHIM + r'''
import sys
import repro.launch.mocha_dryrun as md
md.RESULTS_DIR = sys.argv[1]
for wire in ([], ["--bf16-wire"]):
    sys.argv = ["mocha_dryrun", "--m", "256", "--n", "4", "--d", "3",
                "--steps", "4"] + wire
    md.main()
'''


def test_mocha_round_matches_jax_record(tmp_path):
    """One all-gather of the m x d wire, as JAX's record has it: 3,072 B in
    f32.  With the bf16 wire XLA's CPU pipeline sends it as f32, which
    JAX's ``total_bf16_equiv`` corrects: the port's bf16 gather equals it.
    A rank's block of the arguments is JAX's argument bytes but for the
    keys: the port's are two int64 words a task, JAX's two uint32."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    _run(_PORT_MOCHA, port)
    _run(_JAX_MOCHA, jax_dir)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "count")
    for tag in ("", "_bf16"):
        got = json.loads((port / f"mocha_round__data256{tag}.json")
                         .read_text())
        want = json.loads((jax_dir / f"mocha_round__data256{tag}.json")
                          .read_text())
        assert got["status"] == want["status"] == "ok"
        for key in ("kind", "m", "n", "d", "steps", "bf16_wire", "mesh"):
            assert got[key] == want[key], key
        coll = got["collectives"]
        assert coll["count"] == want["collectives"]["count"] == 1
        if tag:
            assert coll["all-gather"] == coll["total"] == \
                want["collectives"]["total_bf16_equiv"] == 1536
        else:
            for k in kinds:
                assert coll[k] == want["collectives"][k], k
            assert coll["all-gather"] == 3072
        keys = 256 * 2 * (8 - 4)       # int64 against uint32 words
        assert got["memory"]["block_bytes"] == \
            want["memory"]["argument_bytes"] + keys // 256
        assert got["memory"]["temp_bytes"] is None
        assert "cpu" in got["memory"]["temp_bytes_reason"]
        assert got["memory"]["argument_bytes"] > got["memory"]["block_bytes"]


def test_mocha_dryrun_refuses_a_live_group():
    """A probe raises where a process group exists: a fake group must not
    stand in for a real one, nor a real one carry a probe."""
    out = _run(r'''
import torch.distributed as dist
from repro_torch.launch import mocha_dryrun
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    mocha_dryrun.run(m=256, n=4, d=3, steps=4, device="cpu",
                     out_dir="unused")
except RuntimeError as e:
    print("RAISED", "initialized already" in str(e))
print("ALIVE", dist.is_initialized(), dist.get_world_size())
''')
    assert "RAISED True" in out and "ALIVE True 1" in out
