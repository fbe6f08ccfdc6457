"""Roofline analysis: the JAX package's ``launch/roofline.py``.

Per (arch x shape) on the single-pod mesh, the three roofline terms of a
device:

    t_compute    = FLOPs / PEAK_FLOPS       (per device)
    t_memory     = bytes / HBM_BW
    t_collective = collective bytes / ICI_BW

The analytic half (``param_counts``, ``model_flops``) is a pure function
of the config: parameters in total and active a token, and the useful
FLOPs of a step over all devices.  MODEL_FLOPS = 6*N*D (dense) or
6*N_active*D (MoE) for training, 2*N*D for prefill; for decode steps
MODEL_FLOPS = 2*N*(new tokens) + attention-readout FLOPs.
``param_counts`` leaves out the norms' and mixers' vectors and the mamba
convolutions (under 1e-3 of the elements a model holds).

The measured half counts a step's costs a device with the cost probe
(``launch.probe.fake_costs``: ``build_case``'s step as rank 0 of a fake
group of the mesh's size, on FakeTensors, counted on a warm call) where
the JAX package reads XLA's cost analysis of the compiled step: FLOPs
through torch's ``flop_registry`` (matrix products: elementwise work adds
none, where XLA counts it), bytes as every eager operation's inputs and
outputs (XLA's ``bytes accessed`` after fusion is smaller), collective
result bytes (``hlo_stats``).  Attention is counted as the plain route
computes it, the whole score matrix, as the JAX package's HLO counts its
plain jnp attention.  Full-depth costs come by depth differencing, as in
the JAX package: measure the same step at depths L1 and L2, then

    per_layer = (C(L2) - C(L1)) / (L2 - L1);  fixed = C(L1) - L1*per_layer
    C(L) = fixed + L * per_layer

Zamba2 differences whole shared-attention *periods*.

Run:  PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A
      --shape S] [--jobs N]
writes results/roofline_torch/<arch>__<shape>.json and prints the table.
Each depth's probe is a process of its own, on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch.mesh import MeshSpec, make_production_mesh

# NVIDIA H100 SXM5 80GB, at its 700 W power limit (NVIDIA's H100 data
# sheet, dense rates without sparsity); "NVIDIA H100 80GB HBM3, 700.00 W"
# is how nvidia-smi names the card these constants stand for
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12           # HBM3 B/s a card
# The collective term's bandwidth: one 400 Gb/s NDR InfiniBand NIC a card
# (a DGX H100 has eight for its eight cards).  The 16 x 16 mesh's 256
# cards are 32 nodes of 8: ``model``'s 16 consecutive ranks span two
# nodes and ``data``'s 16 ranks (stride 16) sixteen, so every collective
# of the mesh crosses a NIC, and the NIC, not NVLink, sets its time.
ICI_BW = 50e9              # B/s a card a direction (400 Gb/s)
# NVLink 4 (18 links, 900 GB/s a card both ways): the term a collective
# kept inside one node would take, printed beside the NIC's
NVLINK_BW = 450e9          # B/s a card a direction
CHIPS = make_production_mesh().size

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "roofline_torch")


def param_counts(cfg: ArchConfig) -> Tuple[float, float]:
    """(total params, active-per-token params)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    if cfg.block_type == "attention":
        attn = d * cfg.attn_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim \
            + cfg.attn_dim * d
        if cfg.is_moe:
            ffn_one = (3 * d * f if cfg.mlp in ("swiglu", "geglu")
                       else 2 * d * f)
            ffn_total = cfg.n_experts * ffn_one + d * cfg.n_experts
            ffn_active = cfg.top_k * ffn_one + d * cfg.n_experts
        else:
            ffn_total = ffn_active = (3 * d * f if cfg.mlp in
                                      ("swiglu", "geglu") else 2 * d * f)
        layer_total, layer_active = attn + ffn_total, attn + ffn_active
        layers_total = cfg.n_layers * layer_total
        layers_active = cfg.n_layers * layer_active
    elif cfg.block_type == "rwkv6":
        tm = 5 * d * d + d * (cfg.rwkv_lora_decay + 5 * cfg.rwkv_lora_mix) * 2
        cm = d * f + f * d + d * d
        layers_total = layers_active = cfg.n_layers * (tm + cm)
    else:  # mamba2 / zamba2 hybrid
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        gn = cfg.ssm_groups * cfg.ssm_state
        mamba = d * (2 * d_inner + 2 * gn + cfg.ssm_heads) + d_inner * d
        layers = cfg.n_layers * mamba
        if cfg.shared_attn_period:
            shared = (d * cfg.attn_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
                      + cfg.attn_dim * d + 3 * d * f)
            n_apps = cfg.n_layers // cfg.shared_attn_period
            layers += shared + n_apps * 2 * d * d  # unshared projections
            # weight reuse: active compute counts every application
            layers_active = layers + (n_apps - 1) * shared
        else:
            layers_active = layers
        layers_total = layers
    embed = v * d * (cfg.n_codebooks if cfg.family == "audio" else 1)
    head = 0 if cfg.tie_embeddings else d * v * (
        cfg.n_codebooks if cfg.family == "audio" else 1)
    return layers_total + embed + head, layers_active + embed + head


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """Useful FLOPs for the step (global, all chips)."""
    shape = get_shape(shape_name)
    total, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence + attention readout over the cache
    tokens = shape.global_batch
    flops = 2.0 * active * tokens
    if cfg.block_type == "attention" or cfg.shared_attn_period:
        window = cfg.sliding_window or shape.seq_len
        kv = min(window, shape.seq_len)
        n_attn = (cfg.n_layers if cfg.block_type == "attention"
                  else cfg.n_layers // cfg.shared_attn_period)
        flops += (4.0 * tokens * n_attn * cfg.n_heads * cfg.head_dim * kv)
    return flops


# ---------------------------------------------------------------------------
# depth differencing
# ---------------------------------------------------------------------------

def _depths(cfg: ArchConfig) -> Tuple[int, int]:
    if cfg.shared_attn_period:
        return cfg.shared_attn_period, 2 * cfg.shared_attn_period
    return 1, 2


def _shallow(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    return dataclasses.replace(cfg, n_layers=n_layers, scan_layers=False,
                               name=f"{cfg.name}-L{n_layers}")


def _measure(cfg: ArchConfig, shape_name: str, mesh: MeshSpec
             ) -> Dict[str, float]:
    """Probe one config in a process of its own (a fake group of the
    mesh's size), return per-device cost terms: ``flops``, ``bytes``,
    ``coll`` and ``coll_raw``, the per-kind ``collectives``, and the
    probe's own readings."""
    from repro_torch.launch import probe
    return probe.spawn("fake_costs", cfg=dataclasses.asdict(cfg),
                       shape=shape_name, multi_pod="pod" in mesh.axis_names)


def _difference(c1, c2, l1: int, l2: int, n_layers: int) -> Dict:
    """The depth difference of every number of ``c1`` (read at depth l1)
    and ``c2`` (at l2): the full-depth value, its per-layer and fixed
    parts."""
    out = {}
    for key, a in c1.items():
        per = (c2[key] - a) / (l2 - l1)
        fixed = a - l1 * per
        out[key] = max(0.0, fixed + n_layers * per)
        out[key + "_per_layer"] = per
        out[key + "_fixed"] = fixed
    return out


_SUMS = ("flops", "bytes", "coll", "coll_raw")


def measure_full_depth(arch: str, shape_name: str,
                       mesh: Optional[MeshSpec] = None) -> Dict[str, float]:
    """Depth-differenced per-device cost terms at the real layer count.
    The two depths' probes run side by side; ``probes`` keeps each one's
    readings."""
    from repro_torch.launch.specs import resolve_arch_for_shape
    cfg, variant = resolve_arch_for_shape(arch, shape_name)
    mesh = mesh or make_production_mesh()
    l1, l2 = _depths(cfg)
    with ThreadPoolExecutor(2) as pool:
        c1, c2 = pool.map(lambda n: _measure(_shallow(cfg, n), shape_name,
                                             mesh), (l1, l2))
    out = {"swa_variant": variant}
    diff = _difference({k: c1[k] for k in _SUMS}, {k: c2[k] for k in _SUMS},
                       l1, l2, cfg.n_layers)
    out.update(diff)
    if "collectives" in c1:
        out["collectives"] = {k: v for k, v in _difference(
            c1["collectives"], c2["collectives"], l1, l2,
            cfg.n_layers).items() if not k.endswith(("_per_layer",
                                                      "_fixed"))}
        out["probes"] = {str(l1): c1, str(l2): c2}
    return out


def roofline_terms(arch: str, shape_name: str, costs: Dict[str, float]
                   ) -> Dict[str, float]:
    from repro_torch.launch.specs import resolve_arch_for_shape
    cfg, _ = resolve_arch_for_shape(arch, shape_name)
    t_comp = costs["flops"] / PEAK_FLOPS
    t_mem = costs["bytes"] / HBM_BW
    t_coll = costs["coll"] / ICI_BW
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(cfg, shape_name)
    flops_global = costs["flops"] * CHIPS
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_ratio": mf / flops_global if flops_global else 0.0,
    }


def run_one(arch: str, shape_name: str, out_dir: str = RESULTS_DIR,
            force: bool = False) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    record = {"arch": arch, "shape": shape_name, "mesh": "pod16x16",
              "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                            "ici_bw": ICI_BW, "nvlink_bw": NVLINK_BW,
                            "chips": CHIPS}}
    try:
        costs = measure_full_depth(arch, shape_name)
        record.update(costs)
        record.update(roofline_terms(arch, shape_name, costs))
        record["t_collective_nvlink_s"] = costs["coll"] / NVLINK_BW
        record["status"] = "ok"
        print(f"[roofline] {arch:24s} {shape_name:12s} "
              f"comp={record['t_compute_s']:.3e}s "
              f"mem={record['t_memory_s']:.3e}s "
              f"coll={record['t_collective_s']:.3e}s "
              f"(nvlink {record['t_collective_nvlink_s']:.3e}s) -> "
              f"{record['dominant']} useful={record['useful_ratio']:.2f}",
              flush=True)
    except Exception as e:  # noqa: BLE001 -- record and continue the matrix
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[-3000:]
        record["traceback"] = traceback.format_exc()[-2000:]
        print(f"[roofline] FAIL {arch} {shape_name}: "
              f"{record['error'].splitlines()[0][:300]}", flush=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None):
    from repro_torch.configs.archs import ALL_ARCHS
    ap = argparse.ArgumentParser(description="Roofline terms of each "
                                 "(arch x shape) on pod16x16")
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases probed at once (two processes each)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    cases = [(a, s) for a in archs for s in shapes]
    with ThreadPoolExecutor(args.jobs) as pool:
        records = list(pool.map(
            lambda c: run_one(*c, out_dir=args.out, force=args.force),
            cases))
    failures = sum(r["status"] != "ok" for r in records)
    print(f"[roofline] done, {failures} failures")


if __name__ == "__main__":
    main()
