"""SmolLM-360M: llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-360M; family card hf:HuggingFaceTB/SmolLM-135M]
32L, d_model 960, 15 heads (GQA kv=5, head_dim 64), d_ff 2560, vocab 49152.
NOTE: 15 heads do not divide the 16-way model axis; the sharding resolver
falls back per-tensor (attention projections shard on the embed/fsdp axis).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152, head_dim=64, mlp="swiglu", norm="rms",
    tie_embeddings=True, long_context="swa_variant",
    source="hf:HuggingFaceTB/SmolLM-135M (SmolLM family card)",
))
