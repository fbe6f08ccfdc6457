"""Single-token attention over a KV cache as Hopper kernels (CUDA C++,
sm_90a): a split phase over chunks of the cache and a merge."""
from repro_torch.kernels.decode_attention.decode_attention import (
    COUNTS, decode_attention, reset_counts, split_plan)
from repro_torch.kernels.decode_attention.ops import (decode_mha,
                                                      merge_slices,
                                                      merge_weights)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

__all__ = ["COUNTS", "decode_attention", "decode_attention_ref",
           "decode_attention_split_ref", "decode_mha", "merge_slices",
           "merge_weights", "reset_counts", "split_plan"]
