"""Granite-3.0 2B base: dense GQA [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, 32 heads (GQA kv=8, head_dim 64), d_ff 8192, vocab 49155.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155, head_dim=64, mlp="swiglu", norm="rms",
    tie_embeddings=True, long_context="swa_variant",
    source="hf:ibm-granite/granite-3.0-2b-base",
))
