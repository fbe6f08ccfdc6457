"""Mixtral 8x7B: sparse MoE with sliding-window attention [arXiv:2401.04088].

32L, d_model 4096, 32 heads (GQA kv=8), per-expert d_ff 14336, vocab 32000,
8 experts top-2 routing, SWA window 4096 -> long_500k runs natively on a
ring KV cache.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, mlp="swiglu", norm="rms",
    n_experts=8, top_k=2, sliding_window=4096, long_context="native",
    source="arXiv:2401.04088 (Mixtral of Experts)",
))
