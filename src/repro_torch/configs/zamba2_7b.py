"""Zamba2-7B: Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].

81 Mamba2 layers (d_model 3584, d_inner 7168 = 112 heads x 64, state 64)
with a shared full-attention transformer block (32 heads, kv=32,
head_dim 112, d_ff 14336) applied every 6th layer through per-invocation
(unshared) input projections over concat(hidden, initial embedding).
SSM state decode is O(1); the shared-attention KV cache is seq-sharded ->
long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, head_dim=112, mlp="swiglu", norm="rms",
    block_type="mamba2", ssm_state=64, ssm_heads=112, ssm_head_dim=64,
    ssm_groups=1, conv_width=4, ssm_chunk=64, ssm_expand=2,
    shared_attn_period=6, long_context="native",
    source="arXiv:2411.15242 (Zamba2)",
))
