"""Causal / sliding-window flash attention as a Hopper kernel (CUDA C++,
sm_90a)."""
from repro_torch.kernels.flash_attention.flash_attention import (
    COUNTS, flash_attention, reset_counts)
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["COUNTS", "attention_ref", "flash_attention", "flash_mha",
           "reset_counts"]
