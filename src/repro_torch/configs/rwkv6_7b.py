"""RWKV6 (Finch) 7B: attention-free with data-dependent decay [arXiv:2404.05892].

32L, d_model 4096, 64 rwkv heads of dim 64, channel-mix d_ff 14336,
vocab 65536. O(1)-state decode -> long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=14336,
    vocab_size=65536, block_type="rwkv6", rwkv_head_dim=64,
    rwkv_lora_decay=64, rwkv_lora_mix=32, norm="layer",
    long_context="native",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
))
