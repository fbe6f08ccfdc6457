"""StarCoder2-15B: dense GQA with RoPE, plain-GELU MLP [arXiv:2402.19173].

40L, d_model 6144, 48 heads (GQA kv=4, head_dim 128), d_ff 24576,
vocab 49152, LayerNorm.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128, mlp="gelu", norm="layer",
    long_context="swa_variant",
    source="arXiv:2402.19173 (StarCoder2)",
))
