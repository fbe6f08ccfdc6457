"""Granite-3.0 1B-A400M base: fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model 1024, 16 heads (GQA kv=8), per-expert d_ff 512, vocab 49155,
32 experts top-8 routing.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64, mlp="swiglu", norm="rms",
    n_experts=32, top_k=8, tie_embeddings=True, long_context="swa_variant",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
