"""Causal / sliding-window flash attention as Hopper kernels (CUDA C++,
sm_90a): wgmma and TMA for bf16 at head_dim 64, 128 and 256, the CUDA cores
for f32 and the other head dims."""
from repro_torch.kernels.flash_attention.flash_attention import (
    COUNTS, design, flash_attention, reset_counts)
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, attention_tolerance, flash_tolerance)

__all__ = ["COUNTS", "attention_ref", "attention_tolerance", "design",
           "flash_attention", "flash_mha", "flash_tolerance", "reset_counts"]
