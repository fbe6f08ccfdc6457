"""A segment of queries over a whole KV cache, masked by the positions the
cache holds, as a Hopper kernel (CUDA C++, sm_90a)."""
from repro_torch.kernels.cache_attention.cache_attention import (
    COUNTS, cache_attention, design, reset_counts, shared_bytes, split_plan)
from repro_torch.kernels.cache_attention.ops import cache_mha
from repro_torch.kernels.cache_attention.ref import (NEG_INF,
                                                     cache_attention_ref,
                                                     cache_mask,
                                                     cache_tolerance)

__all__ = ["COUNTS", "NEG_INF", "cache_attention", "cache_attention_ref",
           "cache_mask", "cache_mha", "cache_tolerance", "design",
           "reset_counts", "shared_bytes", "split_plan"]
