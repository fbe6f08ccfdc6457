"""Roofline analysis, its analytic half: the JAX package's
``launch/roofline.py`` (``param_counts``, ``model_flops``).

Both are pure functions of the config: parameters in total and active a
token, and the useful FLOPs of a step over all devices.  MODEL_FLOPS =
6*N*D (dense) or 6*N_active*D (MoE) for training, 2*N*D for prefill; for
decode steps MODEL_FLOPS = 2*N*(new tokens) + attention-readout FLOPs.
``param_counts`` leaves out the norms' and mixers' vectors and the mamba
convolutions (under 1e-3 of the elements a model holds).

The measured half waits for ROADMAP.md item 23: the depth-differenced
costs of a compiled step (the JAX package compiles each step at two
depths and differences XLA's HLO cost analysis), and peak constants of
the card in place of the TPU v5e's that the JAX module holds.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import get_shape


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
