"""Single-token attention over a KV cache as a Hopper kernel (CUDA C++,
sm_90a)."""
from repro_torch.kernels.decode_attention.decode_attention import (
    COUNTS, decode_attention, reset_counts)
from repro_torch.kernels.decode_attention.ops import decode_mha
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["COUNTS", "decode_attention", "decode_attention_ref",
           "decode_mha", "reset_counts"]
