"""Gemma-2B: GeGLU, head_dim 256, MQA (kv=1) [arXiv:2403.08295].

18L, d_model 2048, 8 heads, d_ff 16384 (GeGLU), vocab 256000, tied
embeddings. MQA's single KV head cannot shard over heads -- the decode KV
cache shards over the sequence axis instead (see launch/sharding.py).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256, mlp="geglu", norm="rms",
    tie_embeddings=True, long_context="swa_variant",
    source="arXiv:2403.08295 (Gemma)",
))
