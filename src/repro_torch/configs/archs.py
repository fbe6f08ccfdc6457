"""Import all assigned architecture configs (registration side effects)."""
from repro_torch.configs import (gemma_2b, granite_3_2b,  # noqa: F401
                                 granite_moe_1b_a400m, llava_next_mistral_7b,
                                 mixtral_8x7b, musicgen_medium, rwkv6_7b,
                                 smollm_360m, starcoder2_15b, zamba2_7b)

ALL_ARCHS = [
    "smollm-360m", "musicgen-medium", "llava-next-mistral-7b", "rwkv6-7b",
    "mixtral-8x7b", "granite-moe-1b-a400m", "zamba2-7b", "gemma-2b",
    "granite-3-2b", "starcoder2-15b",
]
